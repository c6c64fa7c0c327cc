"""The yardstick: peaks, roofline arithmetic, traffic, spans, trace
reduction, statistics and the benchmark file.  Nothing here imports the
program."""
