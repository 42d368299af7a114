"""One module a kind of job, found by name: `<protocol>_<job>.py`, the
protocol from the cell's configuration and the job from its traffic mix.
Each holds a `Job` class (see `portbench/run.py` for what the harness asks
of it)."""
