"""One reader a end-to-end metric, found by the metric's name:
`<name>.py` holds `read(run)`, which returns the metric's value from the
measured window (`portbench/run.py` `Window`), or None where the cell has
nothing for it to read."""
