"""The kinds of traffic, one module each, found by the `kind` a traffic file
names (`traffic/<traffic>.json` -> `kinds/<kind>.py`). A kind module gives:

- `setup(cell, seed, device, workdir) -> st`: the program's object, driven
  from the seed through the steps the check compares, and every shape the
  window uses warmed up;
- `window(st, cell, seconds, device) -> (attempted, value, lines)`: the
  measured window; `value` is the traffic's end-to-end metric
  (`traffic["metric"]`), `lines` what the run prints about it;
- `traced(st, cell, device, workdir) -> ctx`: the traced run's readings
  for the per-layer readers (`window` with `busy_s`, `window_s`,
  `device_ops`, `idle_gaps`; `ops`, `spans`, `counts`), and `attempted`;
- `release(st)`: drop the program's state before the check;
- `check(st, cell, seed, device) -> {"numbers": {...}, ...}`: the numbers
  the cell's limits name, against the plain reference.
"""
