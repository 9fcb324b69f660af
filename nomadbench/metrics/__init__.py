"""One reader a metric: ``<metric name>.py`` defines ``read(run)``, which
returns the metric's value or None where the run holds nothing to read
(the harness then leaves the metric out of the line)."""
