"""One driver per traffic kind, found by the `kind` a mix names.

`benchmark/drivers/<kind>.py` reads the mixes of its kind, builds their
inputs from the seed, drives the program and judges what it produced.
A new kind is a new file here plus its data files; no file that is there
changes. A driver defines:

- `setup(cell, seed, device, tmpdir) -> state`: inputs, the program built
  and warmed up on every shape the window uses;
- `instrument(state, tracer)`: forward hooks a per-layer metric reads;
- `measure(state, seconds, tracer) -> record`: the window, with at least
  `window_s`, `steps` (seconds of each step) and `attempted`;
- `end_to_end(record) -> {metric: value}`: the end-to-end metrics the
  kind's cells report, besides `setup_s`;
- `check(state, record, device, seed) -> {number: value}`: the numbers
  compared with the cell's limits (`missing_*` counts are the run's
  failures), after the program's state is freed;
- `work(record, cell) -> dict`: what the window completed, for the
  per-layer metrics' readers;
- `control(cell, seed, device, tmpdir) -> {number: value}`: the same
  numbers with the reference one precision step below in the program's
  place (benchmark/control.py).
"""
