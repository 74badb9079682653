"""Host utilities: the data and results folders from the environment
(`paths`) and segmentation overlay PNGs (`overlay`)."""
