"""One runner a kind of traffic, named by a mix's ``runner`` key: it sets
up the program, runs the measured window and hands the records and the
checks to the harness.  The only modules that call into ``repro_torch``."""
