"""Operations and bytes of the port's CUDA kernel families, one module a
family: each names the port's launch counters (``COUNTERS``), the
fragments of its kernels' names in a trace (``NAMES``), and the least time
of one launch of each op at a configuration's shapes (``launch_bounds``)
against the card's published peaks (`benchmark.peaks`)."""
