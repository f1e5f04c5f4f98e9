"""The program's entries that a cell's window drives: one module per `path`
that a traffic file may name, `paths/<path>.py`, found by that name
(cells.path_class) and exposing its class as `Path`.  A new kind of entry
(a scanner, a soft-output receiver, a channel with other impairments, an
open loop) is a new file here; no existing file changes.

A path builds its inputs from the seed (traffic.py) and its receiver from
the configuration, and offers the window:

  setup()                 make the traffic, stage it, build the receiver
  push(step)              enqueue one block and return its output
  collect(out)            copy the block's frames to the host through the
                          program's own sink (inside the window)
  for_check(out, frames)  the collected frames with any field the check
                          compares that the sink leaves out (after the
                          window)
  close()                 free what set-up made outside the process
  samples_per_push, work()  the input samples a push takes, and the
                          shapes the layers' rooflines count work from

and for the check: `ref` (the reference's Spec), `span` (how far either
side of a frame the reference searches), `expected(step)` the frames due
in a push, `t_origin(step)`, and `stream(channel, lo, hi, q)`, the
receiver's input samples as the reference sees them, made from the traffic
alone.  Pushes are numbered from the first warm-up push, so block
`step % blocks` enters at step `step`.  A path may name its own closed or
open loop as `loop` (a harness.Loop); the harness's closed loop is the
default.
"""
