"""Host utilities: the data and results folders from the environment
(`paths`), segmentation overlay PNGs (`overlay`), and parameter and
operation counts, traces and latency benchmarks (`profiling`)."""
