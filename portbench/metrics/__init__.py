"""One reader per metric, found by the metric's name: ``read(run)`` takes
``run.Run`` and returns the number, or None when the run holds nothing
to read (the harness then leaves the metric out of the line)."""
