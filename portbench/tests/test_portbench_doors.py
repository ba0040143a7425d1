"""A new chain and a new loop kind are added as files alone: a toy chain
(``chains/<name>.py``) and a toy per-frame loop that keeps state
(``loopkinds/<name>.py``), written with their configuration, traffic and
cell into a copy of the harness, are found by name and run, and no file of
the copy but ``BENCHMARK.json`` (its new entries) changes."""
from __future__ import annotations

import filecmp
import json
import os
import shutil
import subprocess
import sys
import textwrap

from portbench import manifest

TOY_CHAIN = '''
"""A toy chain: a frame is a (4, 4) float32 tile; the program keeps the
running sum of the frames it has seen, in float32."""
import torch


def frames(cfg, n, seed, salt, device):
    g = torch.Generator(device=device).manual_seed(seed * 1000 + salt)
    return torch.rand((n, cfg["side"], cfg["side"]), generator=g, device=device)


def tops(cfg, count, seed, salt):
    return [None] * count


class Program:
    def __init__(self, cfg, device):
        self.total = None

    def step(self, frame):
        self.total = frame.clone() if self.total is None else self.total + frame
        return self.total.clone()


class Control(Program):
    def step(self, frame):  # one precision down
        return super().step(frame.half().float())


def system(name, cfg, device):
    return {"program": Program, "control": Control}[name](cfg, device)


def reference(frames, cfg, top):
    return frames.double().cumsum(0)


def compare(samples, pool, cfg, device):
    ref = reference(pool, cfg, None)
    gap = max(float((out.double() - ref[key]).abs().max()) for (key, _), out in samples)
    return {"toy_gap": gap}


def chain_bytes(cfg, frames):
    return frames * cfg["side"] ** 2 * 4 * 2
'''

TOY_LOOP = '''
"""A toy per-frame loop: the frames of a pool one at a time through the
system's ``step``, which keeps state from frame to frame."""
import time

from portbench import loops, manifest


def run(system, cfg, traffic, seed, seconds, trace, device):
    pool = manifest.chain(cfg).frames(cfg, traffic["frames"], seed, 0, device)
    result = loops.Run(start_epoch=time.time())
    t0 = time.perf_counter()
    result.samples = [((i, None), system.step(pool[i])) for i in range(len(pool))]
    result.elapsed_s = time.perf_counter() - t0
    result.attempted = result.completed = result.steps = len(pool)
    result.pool = pool
    return result


def check(run, cfg, traffic, seed, device):
    return {"toy_missing": float(traffic["frames"] - len(run.samples))}
'''

DRIVE = '''
import json
from portbench import check, manifest, run, work
bench = manifest.load()
cell = manifest.cell(bench, "toy.frames")
cfg, traffic = manifest.config(bench, cell), manifest.traffic(cell)
out = {}
for system in ("program", "control"):
    r, numbers = run.execute(cell, cfg, traffic, 5, 0.1, False, "cpu", system)
    out[system] = check.verdict(numbers, check.limits(cfg, traffic), r.failed)
out["bytes"] = manifest.chain(cfg).chain_bytes(cfg, 3)
out["least_s"] = work.least_seconds(cfg, 3, "NVIDIA H100 80GB HBM3")
print(json.dumps(out))
'''


def test_a_toy_chain_and_a_toy_loop_run_from_files_alone(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(manifest.HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = manifest.load()
    bench["configs"].append({"name": "toy_running", "source": "a toy", "reduced": [],
                             "file": "portbench/configs/toy_running.json", "why": "a test"})
    bench["workloads"].append({"name": "toy.frames", "config": "toy_running",
                               "traffic": "toy_frames", "chips": 1, "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    pb = root / "portbench"
    (pb / "chains" / "toy_running.py").write_text(textwrap.dedent(TOY_CHAIN))
    (pb / "loopkinds" / "toy_frames.py").write_text(textwrap.dedent(TOY_LOOP))
    (pb / "configs" / "toy_running.json").write_text(json.dumps(
        {"name": "toy_running", "chain": "toy_running", "side": 4,
         "limits": {"toy_gap": 1e-4, "toy_missing": 0}}))
    (pb / "traffic" / "toy_frames.json").write_text(json.dumps({"loop": "toy_frames",
                                                                "frames": 50}))
    env = dict(os.environ, PYTHONPATH=str(manifest.ROOT))
    proc = subprocess.run([sys.executable, "-c", DRIVE], cwd=root, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.splitlines()[-1])
    ok, checks = out["program"]
    assert ok is True and set(checks) == {"toy_gap", "toy_missing"}, checks
    assert out["control"][0] is False, out["control"]
    assert out["bytes"] == 3 * 16 * 4 * 2
    assert out["least_s"] == 3 * 16 * 4 * 2 / 3.35e12
    added = {"chains/toy_running.py", "loopkinds/toy_frames.py", "configs/toy_running.json",
             "traffic/toy_frames.json"}
    for path in manifest.HERE.rglob("*"):
        rel = path.relative_to(manifest.HERE)
        if path.is_file() and "__pycache__" not in rel.parts:
            assert filecmp.cmp(path, pb / rel, shallow=False), rel
    copied = {str(p.relative_to(pb)) for p in pb.rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}
    assert copied - {str(p.relative_to(manifest.HERE)) for p in manifest.HERE.rglob("*")
                     if p.is_file() and "__pycache__" not in p.parts} == added
