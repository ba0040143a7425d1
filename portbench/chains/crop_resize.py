"""The chain of configs 4 and 5, and of every configuration that names no
``chain``: crop at a top held on the device, an optional affine warp, the
bilinear resize, CHW float32, self-statistics normalize (``reference.py``).

A chain is a module ``chains/<name>.py`` that a configuration names by its
``chain`` key (``manifest.chain``).  The harness calls these names of it
and nothing else:

* ``frames(cfg, n, seed, salt, device)``: ``n`` inputs made from the seed
  on ``device``, stacked on the leading axis, of any shape and dtype;
* ``tops(cfg, count, seed, salt)``: one run-time parameter for each of
  ``count`` batches of a pool (here the crop's top), drawn from the seed;
* ``system(name, cfg, device)``: ``"program"``, the port as configured, or
  ``"control"``, the reference one precision down, with the methods the
  cell's loop calls (``systems.py`` has those of the built-in loops);
* ``reference(frames, cfg, top)``: the plain reference's output, float64;
* ``compare(samples, pool, cfg, device)``: named numbers over the kept
  ``((pool key, top), output)`` pairs, each held to ``cfg["limits"]``;
* ``chain_bytes(cfg, frames)``: the least bytes of ``frames`` inputs
  (``work.least_seconds``).

This one is the harness's own modules: ``inputs``, ``systems``,
``reference`` through ``check``, and ``work``.
"""
from portbench import check, inputs, systems, work

frames = inputs.frames
tops = inputs.tops
compare = check.compare
chain_bytes = work.chain_bytes


def system(name: str, cfg: dict, device):
    return systems.build(name, cfg, device)


def reference(frames, cfg: dict, top):
    return check.reference_of(frames, cfg, top)[0]
