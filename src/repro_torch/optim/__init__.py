"""AdamW with its schedule and clipping, and int8 gradient compression."""
