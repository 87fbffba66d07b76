"""Metric readers: ``metrics/<name>.py`` defines ``read(run)``, which
returns the metric's value from a run's record, or None where the run has
nothing for it to read (the harness then leaves the metric out)."""
