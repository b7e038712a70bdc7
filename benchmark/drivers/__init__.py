"""Drivers: one module per kind of configuration, named by its file's
"driver" key. Each has `run(cell, seed, seconds, trace, control, device,
t0) -> harness.Outcome`."""
