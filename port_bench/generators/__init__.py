"""Traffic generators: each reads a traffic mix's data file, builds the
program under test from the cell's configuration, runs the measured window
and the correctness check, and, with --trace 1, the per-layer record.
These are the only modules of the benchmark that import the port."""
