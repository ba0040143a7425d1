"""The face-alignment chain (configuration ``align_faces_1080p``): every face
of a batch of (H, W, 3) u8 BGR frames, each with its own similarity
transform, warped to the recognition network's input and normalized with
fixed statistics, the planes in RGB order.

The names the harness calls (``chains/crop_resize.py`` lists them):

* ``frames(cfg, n, seed, salt, device)``: ``n`` frames of uniform u8 from
  the seed, on the device;
* ``tops(cfg, count, seed, salt)``: the run-time parameter of a batch of
  ``count`` frames, its face table (``Faces``: frame index, forward matrix
  and box side of each face), drawn from the seed as the configuration's
  ``deployment_assumptions`` say: each frame's face count from the clipped
  geometric, each face's box side, roll and centre independently, so K
  moves from batch to batch; ``face_tables`` draws many in bulk
  (``TablePool``), the counts shared by ``batches_per_count`` tables in a
  row (the same cameras' next frames), the faces taken in turn from a pool
  of faces drawn alone, and ``tables_on_device`` puts them on the device in
  one copy each;
* ``system(name, cfg, device)``: ``Program`` (the port's ``Aligner``) or
  ``Control`` (this reference in bfloat16), each with ``batch(frames,
  top)``, ``top`` the batch's (index, matrices) on the device;
* ``reference(frames, cfg, top)``: the (K, 3, h, w) output, float64;
* ``compare(samples, pool, cfg, device)``: ``max_err_lsb`` and
  ``off_share`` of the kept outputs against the reference (``check.Tally``:
  the gap times the plane's ``stddev + 1e-6``, the u8 steps recovered from
  the output);
* ``chain_bytes(cfg, frames)``: the least bytes of ``frames`` frames at the
  mean face count and box side; ``table_bytes`` those of one face table.

The reference, plain PyTorch that imports nothing of the program: the input
stage of ArcFace as InsightFace publishes it (``face_align.norm_crop``: the
similarity warp to 112 x 112, INTER_LINEAR, border 0; RGB planes; (x -
127.5) / 127.5) through vacv's ``warp_affine_normalize`` (cv.h:172-178):
each forward matrix inverted in float64 and stored as float32; the source
coordinate ``((m0 dx) + (m1 dy)) + m2`` in float32 and Q11 weights of its
fraction; the four taps, 0 outside the frame, summed exactly in float64;
truncated as ``floor(x + 1e-4)`` clipped to [0, 255]; ``(x - mean) /
(stddev + 1e-6)`` per output plane.  Departures from InsightFace, both
vacv's: the ``+ 1e-6``; the weights, Q11 of the exact fraction where
OpenCV's ``warpAffine`` rounds the coordinate to a 1/32 pixel grid and
takes Q15 weights of that (a value may differ from OpenCV's by an LSB or
two).  TF32 is off for the reference's sake; it multiplies no matrices.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from portbench import check, systems
from portbench.stats import rng

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

Q11 = 2048.0
TRUNC_EPS = 1e-4
NORM_EPS = 1e-6
BLOCK = 64  # faces the reference takes at a time


@dataclass
class Faces:
    """One batch's face table, on the host."""

    index: np.ndarray     # (K,) int32 frame of each face
    matrices: np.ndarray  # (K, 2, 3) float32 forward matrices
    sides: np.ndarray     # (K,) float64 box sides in source pixels


def frames(cfg: dict, n: int, seed: int, salt: int, device) -> torch.Tensor:
    fr = cfg["frame"]
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + 7919 * salt + 31) % (1 << 63))
    return torch.randint(0, 256, (n, fr["height"], fr["width"], fr["channels"]),
                         dtype=torch.uint8, device=device, generator=g)


def per_frame(cfg: dict, shape, r: np.random.Generator) -> np.ndarray:
    """Faces in each frame, an array of ``shape``: geometric with the
    configuration's mean, clipped to its range, each frame drawn alone."""
    f = cfg["faces"]
    return np.clip(r.geometric(1.0 / f["per_frame_mean"], size=shape), f["per_frame_min"],
                   f["per_frame_max"])


def similarity(cx, cy, side, roll_deg, out_w: int, to) -> np.ndarray:
    """Forward (K, 2, 3) float32 matrices: vacv's scale/rotation form
    (``get_rotation_matrix_2d`` about the origin, angle ``roll_deg``, scale
    ``out_w / side``), its translation set so that (cx, cy) lands on ``to``
    (the output's centre), as ``warp_affine_rot``'s aux parameter sets it;
    float64, then float32."""
    s = out_w / np.asarray(side, np.float64)
    a = np.deg2rad(roll_deg)
    al, be = s * np.cos(a), s * np.sin(a)
    m = np.empty(al.shape + (2, 3), np.float32)
    m[..., 0, 0], m[..., 0, 1], m[..., 0, 2] = al, be, to[0] - al * cx - be * cy
    m[..., 1, 0], m[..., 1, 1], m[..., 1, 2] = -be, al, to[1] + be * cx - al * cy
    return m


class TablePool:
    """Many face tables, drawn at once (``face_tables``): table ``t`` is
    ``pool[t]``, a ``Faces`` of views into three flat arrays: every
    table's frame indices one after another, and the forward matrices and
    box sides of a pool of faces (its first ``kmax`` repeated at its end, so
    that each table's faces are one contiguous slice)."""

    def __init__(self, index, matrices, sides, spans):
        self.index, self.matrices, self.sides = index, matrices, sides
        self.spans = spans  # (start in index, start in the faces, K) a table

    def __len__(self) -> int:
        return len(self.spans)

    def __getitem__(self, t: int) -> Faces:
        a, o, k = self.spans[t]
        return Faces(self.index[a:a + k], self.matrices[o:o + k], self.sides[o:o + k])


def draw_faces(cfg: dict, k: int, r: np.random.Generator):
    """(matrices, sides) of ``k`` faces, each drawn alone: a log-uniform box
    side, a uniform roll and a centre uniform over the crop."""
    f, c, out = cfg["faces"], cfg["crop"], cfg["out"]
    lo, hi = f["side_px"]
    sides = lo * (hi / lo) ** r.random(k)
    roll = f["roll_deg"] * (2 * r.random(k) - 1)
    cx = c["left"] + c["width"] * r.random(k)
    cy = c["top"] + c["height"] * r.random(k)
    to = (out["width"] / 2, out["height"] / 2)
    return similarity(cx, cy, sides, roll, out["width"], to), sides


def face_tables(cfg: dict, count: int, number: int, seed: int, salt: int,
                faces: int | None = None) -> TablePool:
    """``number`` face tables of batches of ``count`` frames, drawn in bulk
    from one generator: each run of ``batches_per_count`` tables holds the
    same faces per frame (``per_frame``), and the faces are drawn into a
    pool of ``faces`` (enough for every table when None) from which each
    table takes the ones after its predecessor's, cyclically."""
    r = rng(seed, 29, salt)
    run = cfg["faces"]["batches_per_count"]
    per = np.repeat(per_frame(cfg, (-(-number // run), count), r), run, axis=0)[:number]
    ks = per.sum(1)
    total = int(ks.sum())
    pool = total if faces is None else min(int(faces), total)
    matrices, sides = draw_faces(cfg, pool, r)
    kmax = int(ks.max())
    wrap = np.arange(pool + kmax) % pool
    matrices, sides = matrices[wrap], sides[wrap]
    index = np.repeat(np.tile(np.arange(count, dtype=np.int32), number), per.ravel())
    starts = np.cumsum(ks) - ks
    spans = list(zip(starts.tolist(), (starts % pool).tolist(), ks.tolist()))
    return TablePool(index, matrices, sides, spans)


def tops(cfg: dict, count: int, seed: int, salt: int) -> Faces:
    """The face table of a batch of ``count`` frames (module docstring)."""
    return face_tables(cfg, count, 1, seed, salt)[0]


def on_device(table: Faces, device):
    """(index int32, matrices float32) of a face table on ``device``."""
    return (torch.from_numpy(table.index).to(device),
            torch.from_numpy(table.matrices).to(device))


def tables_on_device(pool: TablePool, device) -> list:
    """``on_device`` of each table of ``pool``, its arrays copied once: each
    (index, matrices) a contiguous view of the pool's tensors, cut by
    ``split`` along each run of tables whose faces follow one another."""
    spans = pool.spans
    ks = [k for _, _, k in spans]
    index = torch.from_numpy(pool.index).to(device).split(ks)
    faces = torch.from_numpy(np.ascontiguousarray(pool.matrices)).to(device)
    matrices, first = [], 0
    for t in range(1, len(spans) + 1):
        if t == len(spans) or spans[t][1] != spans[t - 1][1] + ks[t - 1]:
            o, run = spans[first][1], ks[first:t]
            matrices.extend(faces[o:o + sum(run)].split(run))
            first = t
    return list(zip(index, matrices))


# --- the plain reference -------------------------------------------------

def inverse(matrices: np.ndarray) -> np.ndarray:
    """(K, 6) inverses of (K, 2, 3) forward matrices, float64, stored as float32."""
    m = np.asarray(matrices, np.float64).reshape(-1, 2, 3)
    det = m[:, 0, 0] * m[:, 1, 1] - m[:, 0, 1] * m[:, 1, 0]
    a = np.stack([np.stack([m[:, 1, 1], -m[:, 0, 1]], -1),
                  np.stack([-m[:, 1, 0], m[:, 0, 0]], -1)], -2) / det[:, None, None]
    b = -np.einsum("kij,kj->ki", a, m[:, :, 2])
    return np.concatenate([a, b[:, :, None]], axis=2).reshape(-1, 6).astype(np.float32)


def reference(frames: torch.Tensor, cfg: dict, top, dtype=torch.float64) -> torch.Tensor:
    """(K, 3, h, w) in ``dtype`` of the faces ``top`` = (index, matrices)
    of (N, H, W, 3) u8 ``frames`` (float64; the control's bfloat16, the
    coordinates and weights then in bfloat16 too)."""
    index, matrices = top
    out, dev = cfg["out"], frames.device
    oh, ow = out["height"], out["width"]
    n, h, w, _ = frames.shape
    grid = torch.float32 if dtype == torch.float64 else dtype
    minv = torch.from_numpy(inverse(matrices.cpu().numpy())).to(dev, grid)
    face = index.to(dev, torch.int64)
    mean = torch.tensor(cfg["mean"], dtype=dtype, device=dev).reshape(3, 1, 1)
    std = torch.tensor(cfg["stddev"], dtype=dtype, device=dev).reshape(3, 1, 1)
    flat = frames.reshape(n, h * w, 3)
    dx = torch.arange(ow, device=dev, dtype=grid)[None, None, :]
    dy = torch.arange(oh, device=dev, dtype=grid)[None, :, None]
    outs = []
    for b0 in range(0, face.shape[0], BLOCK):
        m = minv[b0:b0 + BLOCK].reshape(-1, 6, 1, 1)
        taps = []
        for r in (0, 1):
            f = (m[:, 3 * r] * dx + m[:, 3 * r + 1] * dy) + m[:, 3 * r + 2]
            fl = torch.floor(f)
            w0 = torch.floor((1.0 - (f - fl)) * Q11 + 0.5) / Q11
            taps.append((fl.to(torch.int64), w0.to(dtype), (1.0 - w0).to(dtype)))
        (sx, wx0, wx1), (sy, wy0, wy1) = taps
        base = face[b0:b0 + BLOCK, None, None]
        acc = 0
        for tx, wx in ((sx, wx0), (sx + 1, wx1)):
            for ty, wy in ((sy, wy0), (sy + 1, wy1)):
                inside = (tx >= 0) & (tx < w) & (ty >= 0) & (ty < h)
                vals = flat[base, ty.clamp(0, h - 1) * w + tx.clamp(0, w - 1)].to(dtype)
                acc = acc + vals * torch.where(inside, wx * wy, 0)[..., None]
        planes = torch.clamp(torch.floor(acc + TRUNC_EPS), 0, 255).permute(0, 3, 1, 2)
        if cfg["to_rgb"]:
            planes = planes.flip(1)
        outs.append((planes - mean) / (std + NORM_EPS))
    if not outs:
        return torch.empty((0, 3, oh, ow), dtype=dtype, device=dev)
    return torch.cat(outs)


# --- the systems ----------------------------------------------------------

class _Table:
    """The Aligner as ``systems.Program.batch`` calls its ``pre``: a batch's
    ``top`` is its face table (index, matrices) on the device."""

    def __init__(self, aligner):
        self.aligner = aligner

    def batch(self, frames, top):
        return self.aligner.batch(frames, *top)


class Program(systems.Program):
    """The port's ``Aligner`` as the configuration states it.  ``batch`` is
    ``systems.Program.batch``, ``self.pre.batch(frames, top=top)``, so a
    fault planted there (``tests/faults.py``) lies on this program's path."""

    def __init__(self, cfg: dict, device):
        from vacv_tpu_torch.models import Aligner

        out = cfg["out"]
        self.aligner = Aligner((out["width"], out["height"]), cfg["mean"], cfg["stddev"],
                               cfg["to_rgb"], device=device)
        self.pre = _Table(self.aligner)
        self.cfg = cfg

    def check_route(self, frames: torch.Tensor) -> None:
        route = self.aligner.route(frames.device)
        want = self.cfg["route"] if frames.device.type == "cuda" else self.cfg["route"] + "_torch"
        if route != want:
            raise RuntimeError(f"the program takes route {route!r}, the configuration states {want!r}")

    def counters(self) -> dict:
        from vacv_tpu_torch.utils import trace

        return {k: trace.counter(k) for k in ("align.batches", "align.rois", "align_faces",
                                              "align_faces_torch")}


class Control:
    """The reference in bfloat16 in the program's place."""

    def __init__(self, cfg: dict, device):
        self.cfg = cfg

    def check_route(self, frames) -> None:
        pass

    def batch(self, frames, top):
        return reference(frames, self.cfg, top, torch.bfloat16).float()

    def counters(self) -> dict:
        return {}


def system(name: str, cfg: dict, device):
    return {"program": Program, "control": Control}[name](cfg, device)


# --- the check --------------------------------------------------------------

def compare(samples, pool, cfg: dict, device) -> dict:
    """The numbers over every kept ``((batch index, None), output)``; ``pool``
    holds each batch's (frames, index, matrices)."""
    tally = check.Tally()
    for (j, _), out in samples:
        frames_j, index, matrices = pool[j]
        ref = reference(frames_j, cfg, (index, matrices))
        std = torch.tensor(cfg["stddev"], dtype=torch.float64, device=ref.device)
        tally.add(out.to(ref.device).reshape(ref.shape), ref, std.expand(ref.shape[0], 3))
    return tally.numbers()


# --- the work ---------------------------------------------------------------

def face_bytes(cfg: dict, sides) -> np.ndarray:
    """Each face's least bytes: its f32 output written once and the u8
    source bytes its taps can reach, 3 min(b^2, 4 h w) for a box side b of
    the source (an output pixel reads 2 x 2 taps)."""
    out = cfg["out"]
    hw = out["height"] * out["width"]
    return 3 * hw * 4 + 3 * np.minimum(np.square(np.asarray(sides, np.float64)), 4 * hw)


def table_bytes(cfg: dict, table: Faces) -> float:
    """The least bytes of one batch's face table."""
    return float(face_bytes(cfg, table.sides).sum())


def chain_bytes(cfg: dict, frames: int) -> int:
    """The least bytes of ``frames`` frames: the mean face count, each face
    at the mean of ``face_bytes`` over the log-uniform box side."""
    f, out = cfg["faces"], cfg["out"]
    lo, hi = f["side_px"]
    cap = 4 * out["height"] * out["width"]
    knee = min(max(math.sqrt(cap), lo), hi)
    span = math.log(hi / lo)
    mean_sq = (knee ** 2 - lo ** 2) / (2 * span) + cap * math.log(hi / knee) / span
    per_face = 3 * out["height"] * out["width"] * 4 + 3 * mean_sq
    return int(round(frames * f["per_frame_mean"] * per_face))


def roofline(result) -> float | None:
    """100 x the profiled batches' least time (``table_bytes`` at the
    card's published bandwidth) over the device time of the alignment
    kernel, found by name in the trace's operations.  The batches the card
    ran in the sub-window are its busy time over a batch's device time (the
    kernels launched inside ``align.batch`` spans, over those spans); their
    mix is that of the batches the loop profiled (``run.extra
    ["profiled"]``, counts by pool index).  Nothing when the card has no
    published bandwidth or the trace holds no such kernel."""
    from portbench import work

    t = result.trace["timeline"] if result.trace else None
    bw = work.peak_bytes_per_s(result.kind)
    counts = result.run.extra.get("profiled")
    tables = result.run.extra.get("tables")
    spans = t["span_counts"].get("align.batch", 0) if t else 0
    if bw is None or not spans or not counts or not tables:
        return None
    batch_s = t["kernels_s"].get("align.batch", 0.0) / spans
    kernel = sum(s for name, s in t["ops"].items() if "align_kernel" in name)
    if batch_s <= 0 or kernel <= 0:
        return None
    least = sum(n * table_bytes(result.cfg, tables[j]) for j, n in enumerate(counts))
    least /= sum(counts) * bw
    return 100.0 * least * (t["busy_s"] / batch_s) / kernel
