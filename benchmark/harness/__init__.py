"""What every cell shares: the manifest and the files found by name, the
set-up clock, the profiler's reading, the frozen peaks and the comparison
helpers."""
