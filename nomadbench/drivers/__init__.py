"""Driver kinds: how a traffic mix drives the system. A mix file names
its kind (``"driver"``); a kind is a module here with three functions:

- ``setup(run)``: what the traffic needs before the window (placing a job,
  filling the cluster) and one warm-up round of the mix's own shape;
- ``window(run, t0, seconds)``: drive the mix from ``t0``, record every
  request (``run.record``) and the states to judge (``run.samples``),
  and return the perf_counter at which the window closed;
- ``finish(run)``: wait for what was due in the window (at most
  ``cluster.EVAL_WAIT_S`` past its due time) and add the final state.
"""
