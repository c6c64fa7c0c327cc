"""The fault-tolerance supervisor around the train loop."""
