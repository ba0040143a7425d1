"""The camera-tracking chain (configuration ``tracking_720p``): every
(H·3/2, W) u8 NV21 frame is searched whole for one template with
TM_CCOEFF_NORMED, and a window of the configuration's ``crop`` rows,
centred on the best match and clamped to the frame, becomes the network
input (bilinear, CHW float32, self-statistics normalize).

The names the harness calls (``chains/crop_resize.py`` lists them):

* ``frames(cfg, n, seed, salt, device)``: ``n`` NV21 frames, a background
  uniform in the configuration's ``background`` range with the template
  pasted at the positions ``tops`` draws, encoded on the device;
* ``tops(cfg, count, seed, salt)``: those positions, ``(x, y)``, the
  planted truths (the loop does not use them; the tests do);
* ``template(cfg, seed, device)``: the (th, tw, 3) u8 BGR template, drawn
  from the seed and shared by every frame;
* ``system(name, cfg, device)``: ``Program`` (the port's ``Tracker``) or
  ``Control`` (this reference in bfloat16);
* ``reference(frame, template, cfg)``: ``(net_in, (x, y), score)``;
* ``compare(samples, pool, cfg, device)``: ``pos_err_px``, the largest
  distance between the program's and the reference's match; ``score_err``,
  the largest gap between their scores; ``max_err_lsb`` and ``off_share``
  of the network input against the reference's at the reference's top
  (``check.py``);
* ``chain_bytes(cfg, frames)``: the NV21 frames read once and the outputs
  (network input, x, y as int64, score as float32) written once.

The frame's work for the per-kernel rooflines: ``corr_flops`` (the
correlation's multiply-adds, two operations each), ``window_sum_bytes``
(the f32 BGR planes read once, Σ_c x² and the three per-channel window
sums written once), ``nv_bytes`` (the window's NV21 bytes read once, the
network input written once); ``least_seconds`` and ``kernel_least_seconds``
turn them into times at the card's published peaks (``peaks.json``,
``peaks_f32.json``).

The reference is plain PyTorch in float64 and imports nothing of the
program: NV21 decoded by vacv's Q7 integer formula (``(227 u) >> 7``,
``(44 u + 91 v) >> 7``, ``(179 v) >> 7`` with an arithmetic, flooring
shift, each chroma pair shared by its 2 × 2 pixels, clamped to [0, 255]);
the correlation of the frame with the template less its per-channel mean,
summed over channels; the window sums of Σ_c x² and of each channel from
integral images, exact in float64; OpenCV's NORMED post-processing (a
response is num / den where |num| < den, ±1 where |num| < 1.125 den, else
0, den = sqrt(max(Σ_c x² − Σ_c (Σ x_c)² / n, 0) · Σ t'²)); the first
maximum in row-major order; then the crop-resize reference of
``reference.py``, called.  Departures from OpenCV's description: the
decode is vacv's Q7 one, not OpenCV's; the window sums are exact, where
OpenCV's come from float integral images; on the card the correlation runs
as ``conv2d`` over blocks of output rows, with TF32 off.
"""
from __future__ import annotations

import json
import math
from pathlib import Path

import torch

from portbench import check, reference as crop_reference, systems, work
from portbench.stats import rng

PEAKS_F32 = Path(__file__).resolve().parent.parent / "peaks_f32.json"
CORR_ROWS = 64  # output rows of one block of the reference's correlation


def _sizes(cfg: dict):
    fr, t = cfg["frame"], cfg["template"]
    return fr["height"], fr["width"], t["height"], t["width"]


def _generator(device, seed: int, salt: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + 7919 * salt + 17) % (1 << 63))
    return g


def template(cfg: dict, seed: int, device) -> torch.Tensor:
    """The (th, tw, 3) u8 BGR template, uniform in the configuration's range."""
    t = cfg["template"]
    g = _generator(device, seed, -1)
    return torch.randint(t["low"], t["high"] + 1, (t["height"], t["width"], 3),
                         dtype=torch.uint8, device=device, generator=g)


def tops(cfg: dict, count: int, seed: int, salt: int) -> list[tuple[int, int]]:
    """The target's (x, y) in each of ``count`` frames, uniform over the
    positions where it fits."""
    h, w, th, tw = _sizes(cfg)
    r = rng(seed, 17, salt)
    xs = r.integers(0, w - tw + 1, size=count)
    ys = r.integers(0, h - th + 1, size=count)
    return [(int(x), int(y)) for x, y in zip(xs, ys)]


def encode_nv21(bgr: torch.Tensor) -> torch.Tensor:
    """(h·3/2, w) u8 NV21 of an (h, w, 3) u8 BGR frame (even h and w): Q14
    luma of every pixel, chroma of the top-left pixel of each 2 × 2 block,
    V before U."""
    b, g, r = (bgr[..., i].to(torch.int32) for i in range(3))
    y = (b * 1868 + g * 9617 + r * 4899) >> 14
    u = torch.clamp(((b - y)[::2, ::2] * 9241 + (128 << 14)) >> 14, 0, 255)
    v = torch.clamp(((r - y)[::2, ::2] * 11682 + (128 << 14)) >> 14, 0, 255)
    vu = torch.stack((v, u), dim=-1).reshape(bgr.shape[0] // 2, bgr.shape[1])
    return torch.cat((y, vu)).to(torch.uint8)


def make_frames(cfg: dict, positions, tmpl: torch.Tensor, seed: int, salt: int,
                device) -> torch.Tensor:
    """(len(positions), H·3/2, W) u8 NV21 frames with ``tmpl`` at each (x, y)."""
    h, w, th, tw = _sizes(cfg)
    lo, hi = cfg["background"]["low"], cfg["background"]["high"]
    g = _generator(device, seed, salt)
    out = torch.empty((len(positions), h * 3 // 2, w), dtype=torch.uint8, device=device)
    for k, (x, y) in enumerate(positions):
        bgr = torch.randint(lo, hi + 1, (h, w, 3), dtype=torch.uint8, device=device, generator=g)
        bgr[y:y + th, x:x + tw] = tmpl
        out[k] = encode_nv21(bgr)
    return out


def frames(cfg: dict, n: int, seed: int, salt: int, device) -> torch.Tensor:
    return make_frames(cfg, tops(cfg, n, seed, salt), template(cfg, seed, device), seed, salt,
                       device)


# --- the plain reference -------------------------------------------------

def decode(nv: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
    """(h, w, 3) BGR of an (h·3/2, w) u8 NV21 frame, vacv's Q7 decode
    computed in ``dtype`` (exact in float64)."""
    h = nv.shape[0] * 2 // 3
    yv = nv[:h].to(dtype)
    vu = nv[h:].to(dtype)

    def spread(c):  # each chroma pair to its 2 x 2 pixels
        return c.repeat_interleave(2, dim=0)[:h].repeat_interleave(2, dim=1)

    v, u = spread(vu[:, 0::2]) - 128, spread(vu[:, 1::2]) - 128
    b = yv + torch.floor(227 * u / 128)
    g = yv - torch.floor((44 * u + 91 * v) / 128)
    r = yv + torch.floor(179 * v / 128)
    return torch.clamp(torch.stack((b, g, r), dim=-1), 0, 255)


def _box(x: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """Sums of (..., H, W) over every th × tw window, from an integral image."""
    s = torch.nn.functional.pad(x.cumsum(-2).cumsum(-1), (1, 0, 1, 0))
    return s[..., th:, tw:] - s[..., :-th, tw:] - s[..., th:, :-tw] + s[..., :-th, :-tw]


def _corr(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Valid correlation of (C, H, W) with (C, th, tw), summed over C, in
    blocks of CORR_ROWS output rows."""
    th = k.shape[1]
    ho = x.shape[1] - th + 1
    rows = []
    with torch.backends.mkldnn.flags(enabled=False), \
            torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for r0 in range(0, ho, CORR_ROWS):
            r1 = min(r0 + CORR_ROWS, ho)
            rows.append(torch.nn.functional.conv2d(x[None, :, r0:r1 + th - 1], k[None])[0, 0])
    return torch.cat(rows)


def normed_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """OpenCV's NORMED post-processing for the CCOEFF family."""
    a = num.abs()
    ratio = num / torch.where(den > 0, den, torch.ones_like(den))
    near = torch.where(num > 0, 1.0, -1.0).to(num.dtype)
    return torch.where(a < den, ratio, torch.where(a < 1.125 * den, near, torch.zeros_like(num)))


def response(bgr: torch.Tensor, tmpl: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
    """The TM_CCOEFF_NORMED map (H - th + 1, W - tw + 1) of an (H, W, 3) image."""
    x = bgr.to(dtype).permute(2, 0, 1)
    k = tmpl.to(dtype).permute(2, 0, 1)
    th, tw = k.shape[1:]
    kc = k - k.mean(dim=(1, 2), keepdim=True)
    num = _corr(x.contiguous(), kc.contiguous())
    wnd2 = _box((x * x).sum(0), th, tw)
    wnd1 = _box(x, th, tw)
    var = wnd2 - (wnd1 * wnd1).sum(0) / (th * tw)
    den = torch.sqrt(torch.clamp(var, min=0) * (kc * kc).sum())
    return normed_div(num, den)


def top_of(cfg: dict, y: int) -> int:
    h, _, th, _ = _sizes(cfg)
    ch = cfg["crop"]["height"]
    return min(max(y - (ch - th) // 2, 0), h - ch)


def _reference(nv: torch.Tensor, tmpl: torch.Tensor, cfg: dict, dtype=torch.float64):
    """(net_in (1, 3, oh, ow), (x, y), score, std (1, 3)) of one frame."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        bgr = decode(nv, dtype)
        resp = response(bgr, tmpl, dtype)
        idx = int(torch.argmax(resp.reshape(-1)))
        y, x = divmod(idx, resp.shape[1])
        score = resp[y, x]
        net_in, std = crop_reference.chain(bgr.to(torch.uint8)[None], cfg, top_of(cfg, y), dtype)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return net_in, (x, y), score, std


def reference(frame: torch.Tensor, tmpl: torch.Tensor, cfg: dict, dtype=torch.float64):
    """``(net_in (1, 3, oh, ow), (x, y), score)`` of one NV21 frame, in
    ``dtype`` (float64; the control's bfloat16)."""
    net_in, xy, score, _ = _reference(frame, tmpl, cfg, dtype)
    return net_in, xy, score


# --- the systems ----------------------------------------------------------

class Program(systems.Program):
    """The port's ``Tracker`` as the loop drives it: ``aim(template)`` once,
    then ``frame(nv)`` for each frame.  ``frame`` is
    ``systems.Program.frame``, which returns ``self.pre(nv)``: here the
    step's network input, with its ``((x, y), score)`` left in ``found``.
    Keeping that method keeps a fault planted in it (``tests/faults.py``)
    on this program's path."""

    def __init__(self, cfg: dict, device):
        self.cfg, self.device = cfg, device
        self.tracker = self.pre = self.found = None

    def aim(self, tmpl: torch.Tensor) -> None:
        from vacv_tpu_torch.models import Tracker

        fr, c, out = self.cfg["frame"], self.cfg["crop"], self.cfg["out"]
        self.tracker = Tracker(tmpl, frame_hw=(fr["height"], fr["width"]), roi_h=c["height"],
                               out_size=(out["width"], out["height"]), device=self.device,
                               roi_left=c["left"], roi_w=c["width"])
        self.pre = self._step

    def _step(self, nv):
        net_in, xy, score = self.tracker.step(nv)
        self.found = (xy, score)
        return net_in

    def check_route(self, frames: torch.Tensor) -> None:
        route = self.tracker.pre.describe_route(frames.shape[1:], frames.dtype, frames.device)
        want = self.cfg["route"] if frames.device.type == "cuda" else "fused_nv_torch"
        if route != want:
            raise RuntimeError(f"the program takes route {route!r}, the configuration states {want!r}")

    def counters(self) -> dict:
        from vacv_tpu_torch.utils import trace

        return {k: trace.counter(k) for k in ("track.frames", "track.graph_replays",
                                              "track.graphs_made")}


class Control:
    """The reference in bfloat16 in the program's place."""

    def __init__(self, cfg: dict, device):
        self.cfg, self.tmpl, self.found = cfg, None, None

    def aim(self, tmpl: torch.Tensor) -> None:
        self.tmpl = tmpl

    def check_route(self, frames) -> None:
        pass

    def frame(self, nv):
        net_in, xy, score = reference(nv, self.tmpl, self.cfg, torch.bfloat16)
        self.found = (xy, score)
        return net_in.float()

    def counters(self) -> dict:
        return {}


def system(name: str, cfg: dict, device):
    return {"program": Program, "control": Control}[name](cfg, device)


# --- the check --------------------------------------------------------------

def compare(samples, pool, cfg: dict, device) -> dict:
    """The numbers over every kept ``((frame index, None), (net_in, (x, y),
    score))``; ``pool`` holds ``frames`` and ``template``."""
    tally, pos, score_err = check.Tally(), 0.0, 0.0
    for (j, _), (net_in, (x, y), score) in samples:
        ref, (rx, ry), rscore, std = _reference(pool["frames"][j], pool["template"], cfg)
        pos = max(pos, math.hypot(int(x) - rx, int(y) - ry))
        gap = abs(float(score) - float(rscore))
        score_err = max(score_err, gap if math.isfinite(gap) else math.inf)
        tally.add(net_in.reshape(ref.shape), ref, std)
    numbers = {"pos_err_px": pos if samples else math.inf, "score_err": score_err}
    numbers.update(tally.numbers())
    return numbers


# --- the work ---------------------------------------------------------------

def chain_bytes(cfg: dict, frames: int) -> int:
    h, w, _, _ = _sizes(cfg)
    out = cfg["out"]
    return frames * (h * 3 // 2 * w + 3 * out["height"] * out["width"] * 4 + 2 * 8 + 4)


def corr_flops(cfg: dict) -> int:
    h, w, th, tw = _sizes(cfg)
    return 2 * (h - th + 1) * (w - tw + 1) * th * tw * 3


def window_sum_bytes(cfg: dict) -> int:
    h, w, th, tw = _sizes(cfg)
    return 4 * (3 * h * w + 4 * (h - th + 1) * (w - tw + 1))


def nv_bytes(cfg: dict) -> int:
    c, out = cfg["crop"], cfg["out"]
    return c["height"] * c["width"] * 3 // 2 + 3 * out["height"] * out["width"] * 4


def peak_f32_flops(kind: str) -> float | None:
    """The published float32 rate (outside the tensor cores) of the card
    named ``kind``, or None."""
    cards = json.loads(PEAKS_F32.read_text())["cards"]
    return cards[kind]["f32_flops_per_s"] if kind in cards else None


def least_seconds(cfg: dict, kind: str) -> float | None:
    """A frame's least time: the larger of the correlation's operations
    at the f32 peak and ``chain_bytes`` at the published bandwidth."""
    flops, bw = peak_f32_flops(kind), work.peak_bytes_per_s(kind)
    if flops is None or bw is None:
        return None
    return max(corr_flops(cfg) / flops, chain_bytes(cfg, 1) / bw)


def kernel_least_seconds(cfg: dict, kind: str) -> dict | None:
    """Each kernel's least time a frame: ``corr`` (operations), ``sums``
    and ``nv`` (bytes)."""
    flops, bw = peak_f32_flops(kind), work.peak_bytes_per_s(kind)
    if flops is None or bw is None:
        return None
    return {"corr": corr_flops(cfg) / flops, "sums": window_sum_bytes(cfg) / bw,
            "nv": nv_bytes(cfg) / bw}


# The kernels of each part of the frame, by the names the trace gives them.
KERNELS = {"corr": ("corr_kernel", "split_sum_kernel"), "sums": ("window_sum_kernel",),
           "nv": ("nv_one_pass_kernel",)}


def kernel_roofline(result, part: str) -> float | None:
    """100 × ``part``'s least time a frame over its device time a frame in
    a traced result.  Its device time is that of the trace's operations
    named as ``KERNELS[part]`` inside the profiled sub-window; the frames the
    card ran there are the sub-window's busy time over a frame's device
    time (the kernels launched inside ``track.frame`` spans, over those
    spans).  Those are fewer than the spans: the card runs behind the host,
    so the last frames launched in the sub-window run after it."""
    t = result.trace["timeline"]
    least = kernel_least_seconds(result.cfg, result.kind)
    spans = t["span_counts"].get("track.frame", 0) if t else 0
    frame_s = t["kernels_s"].get("track.frame", 0.0) / spans if spans else 0.0
    if least is None or frame_s <= 0:
        return None
    busy = sum(s for name, s in t["ops"].items() if any(k in name for k in KERNELS[part]))
    return 100.0 * least[part] * (t["busy_s"] / frame_s) / busy if busy > 0 else None
