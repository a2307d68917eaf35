"""One reader per metric: ``<name>.py`` holds ``read(rec)``, which takes
the run's record (``harness.RunRecord``) and returns the metric's value,
or None when the run holds nothing to read (the harness then leaves the
metric out of the line).  The harness finds a reader by the metric's name
in ``BENCHMARK.json``."""
