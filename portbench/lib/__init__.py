"""The benchmark's yardstick: cell resolution, seeded inputs, peaks, the
work of each kernel, the reduction of a profiler trace, and the
comparisons that decide ``correct``.  Nothing here imports the program."""
