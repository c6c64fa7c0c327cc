"""Training: the chunked loss, the train step and the supervised loop."""
