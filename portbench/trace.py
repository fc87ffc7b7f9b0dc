"""The traced window: the device's operations from the profiler, and the
program's spans marked on the device's own timeline.

`Tracer` records the window under `torch.profiler` with CUDA activity
only (CUPTI: every kernel, copy and set on the device, with its start and
end), so the host pays no per-operator record. The spans are marked on
the stream itself: at each boundary the harness enqueues one marker
kernel (`torch.cuda._sleep`, 1-16 us) and keeps the boundary's label; a
mark's time is its kernel's start in the trace, the moment the device
reached that point of the work. CUPTI may drop a few of a window's
records, so the marks' kernels spin three lengths in turn (`LEVELS`) and
`align` reads the turn back from each kernel's length: a dropped kernel
leaves its mark without a time, and the spans that need it are not read.
So a span costs no synchronisation, and a span's length is what the
device took for the work enqueued inside it. The boundaries come from
wrappers of the benchmark's own, as `zprize_tpu_torch/tools/timeline.py`
wraps the program:

  * "proof" / "proof_end": around each proof of the window (the
    window's own marks, `window.py`);
  * "round:<label>": where the prover ends a round
    (`prover_torch._round_marker`, its round lines, here without the
    sync it makes when `ProverConfig.log` is set);
  * "commit" / "commit_end": around each `prover_torch.commit_batch`;
  * "ntt" / "ntt_end": around each outermost `ops/ntt.transform_last`
    (every NTT and INTT of the one-card path, whatever branch), with the
    shape of its input.

`reduce` turns the profile into plain data (`TraceData`), which the
per-layer metrics read through the helpers below. Only what lies inside
a proof is read: each traced proof runs from its "proof" mark to its
"proof_end" mark, and the operations outside them (the harness's
barriers before and after the window, its broadcast between proofs on
ranks, the marker kernels) are left out of every reading. The traced
window is the sum of the proofs' lengths; the busy time is the union of
the program's device intervals inside them (`tools/timeline` and
`chip_smoke.py`'s `_profile_prove` count it so)."""

import bisect
import time
from dataclasses import dataclass, field

# the k-th mark's kernel spins LEVELS[k % 3] clock cycles: ~1, 4 and 16 us
# at 1.98 GHz (plus ~1 us of the kernel's own), told apart at 3.5 and 11 us
# for any SM clock from 1.3 to 2 GHz
LEVELS = (2000, 8000, 32000)
LEVEL_EDGES_S = (3.5e-6, 11e-6)


@dataclass
class TraceData:
    window_s: float            # device seconds of the traced proofs
    proofs: int                # proofs the window completed
    ops: list                  # (name, start_s, end_s) inside the proofs
    marks: list                # (label, start_s or None), in order
    transforms: list           # (n, batch) of each outermost transform
    busy_s: float              # union of the ops' intervals
    windows: list = field(default_factory=list)  # (start, end) a proof
    notes: list = field(default_factory=list)

    @property
    def traced_proofs(self):
        """The proofs whose both marks have times, which `ops` covers."""
        return len(self.windows)


class Tracer:
    """Markers and the profiler for one process's traced window."""

    def __init__(self):
        self.labels = []
        self.transforms = []
        self.marker_name = None
        self._restore = []
        self._depth = 0

    # -- markers -------------------------------------------------------
    def mark(self, label):
        import torch
        torch.cuda._sleep(LEVELS[len(self.labels) % len(LEVELS)])
        self.labels.append(label)

    def find_marker_name(self):
        """The kernel name of a marker, read from a profile of one."""
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(LEVELS[0])
            torch.cuda.synchronize()
        names = [e.name for e in _device_events(prof)]
        if len(names) != 1:
            raise RuntimeError(f"a marker profiled as {names!r}")
        self.marker_name = names[0]

    # -- the program's boundaries -------------------------------------
    def install(self):
        """Wrap the program's boundaries (undone by `uninstall`)."""
        from zprize_tpu_torch.ops import ntt
        from zprize_tpu_torch.protocol import prover_torch

        def round_marker(cfg):
            def mark(label, arr):
                self.mark("round:" + label)
            return mark

        orig_commit = prover_torch.commit_batch

        def commit_batch(dev_srs, polys, cfg):
            self.mark("commit")
            try:
                return orig_commit(dev_srs, polys, cfg)
            finally:
                self.mark("commit_end")

        orig_transform = ntt.transform_last

        def transform_last(plan, a, invert):
            if self._depth:
                return orig_transform(plan, a, invert)
            self.transforms.append((plan.n, a.numel() // (a.shape[0]
                                                          * plan.n)))
            self.mark("ntt")
            self._depth += 1
            try:
                return orig_transform(plan, a, invert)
            finally:
                self._depth -= 1
                self.mark("ntt_end")

        for mod, name, fn in ((prover_torch, "_round_marker", round_marker),
                              (prover_torch, "commit_batch", commit_batch),
                              (ntt, "transform_last", transform_last)):
            self._restore.append((mod, name, getattr(mod, name)))
            setattr(mod, name, fn)

    def uninstall(self):
        for mod, name, fn in reversed(self._restore):
            setattr(mod, name, fn)
        self._restore = []

    # -- the profiler --------------------------------------------------
    def profiler(self):
        from torch.profiler import ProfilerActivity, profile
        return profile(activities=[ProfilerActivity.CUDA])

    def reduce(self, prof, host_window_s, proofs):
        """The profile as TraceData; call after a synchronize."""
        t0 = time.monotonic()
        events = sorted(((e.name, e.time_range.start * 1e-6,
                          e.time_range.end * 1e-6)
                         for e in _device_events(prof)),
                        key=lambda x: x[1])
        kernels = [(s, e - s) for name, s, e in events
                   if name == self.marker_name]
        marks = align(self.labels, kernels)
        windows = [(s, e) for _, s, e in _pairs(marks, "proof",
                                                 "proof_end")]
        ops = clip([x for x in events if x[0] != self.marker_name],
                   windows)
        data = TraceData(window_s=sum(e - s for s, e in windows),
                         proofs=proofs, ops=ops, marks=marks,
                         transforms=list(self.transforms),
                         busy_s=union_s([(s, e) for _, s, e in ops]),
                         windows=windows)
        timed = sum(t is not None for _, t in marks)
        data.notes.append(f"{len(kernels)} marker kernels for "
                          f"{len(self.labels)} marks, {timed} marks timed")
        data.notes.append(
            f"{len(windows)} of {proofs} proofs traced, "
            f"{data.window_s:.6f} s of a {host_window_s:.6f} s window; "
            f"{len(events) - len(kernels) - len(ops)} device operations "
            f"outside them left out")
        data.notes.append(f"reduced {len(events)} device events in "
                          f"{time.monotonic() - t0:.3f} s")
        return data


def clip(events, windows):
    """The (name, start, end) events, sorted by start, that overlap one
    of the disjoint, sorted (start, end) windows, cut to it."""
    out = []
    starts = [a for a, _ in windows]
    for name, s, e in events:
        i = bisect.bisect_right(starts, s) - 1
        for a, b in windows[max(i, 0):i + 2]:
            if s < b and e > a:
                out.append((name, max(s, a), min(e, b)))
    return out


def level(seconds):
    """Which of LEVELS a marker kernel of this length spun."""
    return bisect.bisect(LEVEL_EDGES_S, seconds)


def align(labels, kernels):
    """[(label, start or None)]: the marker kernels (start, length), in
    order, given to the marks whose turn their length shows; a mark whose
    kernel is missing (up to len(LEVELS) - 1 in a row) gets None. Marks
    after the last kernel get None too."""
    out, k = [], 0
    for start, length in kernels:
        skip = (level(length) - k) % len(LEVELS)
        out.extend((label, None) for label in labels[k:k + skip])
        k += skip
        if k >= len(labels):
            break
        out.append((labels[k], start))
        k += 1
    out.extend((label, None) for label in labels[k:])
    return out


def _device_events(prof):
    from torch.autograd import DeviceType
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def union_s(intervals):
    """Seconds covered by the union of (start, end) intervals."""
    busy, end = 0.0, None
    for s0, s1 in sorted(intervals):
        if end is None or s0 > end:
            busy += s1 - s0
            end = s1
        elif s1 > end:
            busy += s1 - end
            end = s1
    return busy


# ---------------------------------------------------------------------------
# reading a TraceData
# ---------------------------------------------------------------------------

def _pairs(marks, begin, end):
    """[(k, start, end)] of each span from the k-th `begin` mark to the
    `end` mark after it, where both have times."""
    out, open_at, k = [], None, -1
    for label, t in marks:
        if label == begin:
            open_at, k = t, k + 1
        elif label == end:
            if open_at is not None and t is not None:
                out.append((k, open_at, t))
            open_at = None
    return out


def spans(data, begin, end):
    """`_pairs` of the trace's marks."""
    return _pairs(data.marks, begin, end)


def round_spans(data):
    """(label, start, end) of each round: from the proof's start or the
    previous round's end to this round's end, where both have times."""
    out, last = [], None
    for label, t in data.marks:
        if label == "proof":
            last = t
        elif label.startswith("round:"):
            if last is not None and t is not None:
                out.append((label[len("round:"):], last, t))
            last = t
    return out


def mean_round_s(data, label):
    """Mean seconds of the round `label` over the traced proofs."""
    got = [e - s for name, s, e in round_spans(data) if name == label]
    return sum(got) / len(got) if got else None


def idle_share(data):
    """100 * (1 - busy / wall) of the traced window, in %."""
    if data.window_s <= 0 or data.busy_s <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - data.busy_s / data.window_s)


def ops_within(data, start, end):
    """The device operations that start in [start, end)."""
    starts = data._starts if hasattr(data, "_starts") else None
    if starts is None:
        starts = [s for _, s, _ in data.ops]
        data._starts = starts
    i = bisect.bisect_left(starts, start)
    j = bisect.bisect_left(starts, end)
    return data.ops[i:j]


def per_proof(data, seconds):
    """`seconds` summed over the traced proofs' operations, a proof."""
    return seconds / data.traced_proofs if data.traced_proofs else None


def device_ops(data, top=10):
    """[[name, seconds a proof]] of the operations that took most time."""
    by = {}
    for name, s, e in data.ops:
        by[name] = by.get(name, 0.0) + (e - s)
    rows = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    return [[name[:160], per_proof(data, t)] for name, t in rows]


def idle_gaps(data, top=10):
    """[[what the host was doing, idle seconds a proof]]: every stretch of
    a traced proof in which the device ran nothing, charged to the work
    that ended it: the round the next operation belongs to (the first
    round mark after it), with " / commit_batch" when it lies inside a
    commit, or "after the last round" at the proof's end."""
    timed = [(label, t) for label, t in data.marks if t is not None]
    mark_t = [t for _, t in timed]
    labels = [label for label, _ in timed]
    by = {}
    for a, b in data.windows:
        end = a
        for _, s, e in ops_within(data, a, b) + [(None, b, b)]:
            if s > end:
                what = _doing(labels, bisect.bisect_right(mark_t, s))
                by[what] = by.get(what, 0.0) + (s - end)
            end = max(end, e)
    rows = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    return [[what, per_proof(data, t)] for what, t in rows]


def _doing(labels, i):
    """What the host was doing before the i-th timed mark."""
    j = i
    while j < len(labels) and not labels[j].startswith("round:") \
            and labels[j] not in ("proof", "proof_end"):
        j += 1
    if j == len(labels) or not labels[j].startswith("round:"):
        return "after the last round"
    what = labels[j][len("round:"):]
    k = i - 1
    while k >= 0 and labels[k] not in ("commit", "commit_end", "proof"):
        k -= 1
    if k >= 0 and labels[k] == "commit":
        what += " / commit_batch"
    return what
