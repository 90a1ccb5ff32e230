"""The benchmark's frozen measures: the card's peaks, the network's FLOPs,
the tree kernels' bytes and the profiler trace's reduction."""
