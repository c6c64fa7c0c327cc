"""The open-loop serving layer.  Ported so far: ``slo``, the streaming
latency sketch that the obs layer's histograms are built on.  The rest
(arrivals, the standing fleet, load and the HTTP surface) is not ported
yet; this package imports nothing, so ``slo`` loads without the fleet."""
