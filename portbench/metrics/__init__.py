"""One reader a per-layer metric, found by the metric's name: `<name>.py`
holds `read(run)`, which returns the metric from the traced window's
summary (`run.trace`, `portbench/trace.py`) and the counters kept at the
program's boundaries (`run.counters`, `portbench/hooks.py`), or None where
it finds nothing to read. `NEEDS` names the counters it reads, which the
harness keeps only for the metrics of the cell."""
