"""The harness: what every cell shares (the spec, the run's environment,
the profiler's reduction, the checks and the result line)."""
