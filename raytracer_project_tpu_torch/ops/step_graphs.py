"""The fused pool's loop (ops/fused_step.py `render_pool_fused`): on the
card each step replays a captured CUDA graph, on the CPU it launches
step by step (`eager_loop`).

A graph holds one pool step: K1 (or the BVH walk when the tables carry a
BVH), K3 fused with its respawn, and the live count's copy into a pinned
slot. So a turn of the host costs a graph launch and an event, not the
wrappers' checks, allocations and ctypes calls. The graphs and their
workspace are kept between calls (`cache`, a `StepGraphs`), per device,
stream and shape: a key's first call captures them, every later call of
that key replays them. The values that change from call to call (seed,
sample offset, AOV budget, the camera's and environment's parameter
vectors) reach the captured kernels through the entry's fixed buffers,
filled once per call (`_StepGraph.start`).
"""

from __future__ import annotations

import collections
import threading

import torch

from .. import kernels
from ..utils import spans
from . import closest_hit as k1
from . import fused_step as fs

# The libraries a captured step launches from, loaded before a capture.
_LIBRARIES = ("closest_hit", "bvh_hit", "shade_advance")


class _StepGraph:
    """One stream's captured pool step for one key (`StepGraphs.key`): the
    workspace, and two graphs of the step that swap the roles of its two
    state buffers, graph j reading state j and writing state 1 - j. Step k
    of a call (k = 1, 2, ...) replays graph (k - 1) % 2, whose last node
    copies the live count to pinned slot k % 2; the event of that slot is
    recorded after the replay. The two slots are the LIVE_LAG = 2 counts
    the loop reads back. `lock` is held by the call that uses it."""

    def __init__(self, tables: fs.FusedTables, sp: fs.StepParams, p: int,
                 dev):
        nf, ni = fs.state_rows(sp)
        f32, i32, i64 = torch.float32, torch.int32, torch.int64
        self.tables, self.sp, self.p = tables, sp, p
        # (state_f, state_i, next_work, segments), twice.
        self.state = tuple(
            (torch.empty((nf, p), dtype=f32, device=dev),
             torch.empty((ni, p), dtype=i32, device=dev),
             torch.empty((1,), dtype=i32, device=dev),
             torch.empty((1,), dtype=i64, device=dev)) for _ in range(2))
        self.live = torch.empty((1,), dtype=i32, device=dev)
        self.steps = torch.empty((1,), dtype=i64, device=dev)
        # The fog variants' count of segments that end in a medium: one
        # buffer both graphs add to, zeroed at a call's start.
        self.scatters = torch.zeros((1,), dtype=i64, device=dev)
        self.counts = torch.empty((3, -(-p // 256)), dtype=i32, device=dev)
        self.acc = fs.new_accumulator(sp, dev)
        self.dyn = torch.empty((3,), dtype=i32, device=dev)
        self.aparams = torch.empty((8,), dtype=f32, device=dev)
        self.bparams = torch.empty((40,), dtype=f32, device=dev)
        self.pinned = torch.zeros((fs.LIVE_LAG,), dtype=i32, pin_memory=True)
        self.live_host = self.pinned.numpy()
        self.events = tuple(torch.cuda.Event() for _ in range(fs.LIVE_LAG))
        self.graphs = (torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph())
        self.counted = []   # the (wrapper, attr) counts one replay adds
        self.lock = threading.Lock()

    def _slot(self, k: int) -> int:
        """The pinned slot's address for step k's live count."""
        return self.pinned.data_ptr() + 4 * (k % fs.LIVE_LAG)

    def _step(self, j: int) -> None:
        """Graph j's step: K1, K3 fused with its respawn, the count's copy."""
        sf, si, nw, seg = self.state[j]
        out = self.state[1 - j]
        hits = k1.closest_hit(sf[:6], fs.T_MIN, self.tables.scan)
        fs._shade_accumulate_into(
            self.tables, hits, sf, si, nw, seg, self.steps, self.aparams,
            self.bparams, self.sp, self.acc,
            (out[0], out[1], self.counts, out[2], out[3], self.live), self.dyn,
            self.scatters)
        kernels.launch("copy_async_launch", self._slot(j + 1), self.live, 4)

    def capture(self, owner) -> None:
        """Capture both graphs on a side stream (window threads capture at
        once: thread-local capture mode), sharing one memory pool, after
        loading the libraries they launch from; the counts of one step are
        held for its replays."""
        for name in _LIBRARIES:
            kernels.load(name)
        cur = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side), kernels.held_counts() as held:
            for j, g in enumerate(self.graphs):
                g.capture_begin(pool=self.graphs[0].pool() if j else None,
                                capture_error_mode="thread_local")
                try:
                    self._step(j)
                finally:
                    g.capture_end()
        cur.wait_stream(side)
        self.counted = held[:len(held) // 2] + [(owner, "replayed")]
        kernels.count(owner, "captured")

    def start(self, cam, aparams, bparams, sp: fs.StepParams) -> None:
        """This call's inputs into the fixed buffers, the scatter count and
        the accumulator zeroed, the pool's start into state 0 and its live
        count into slot 0."""
        kernels.launch("step_inputs_launch", self.dyn, sp.seed,
                       sp.sample_offset, sp.aux, self.bparams, bparams,
                       self.bparams.numel(), self.aparams, aparams,
                       self.aparams.numel(), self.scatters)
        self.acc.zero_()
        sf, si, nw, seg = self.state[0]
        fs.initial_state(cam, bparams, sp, self.p,
                         out=(sf, si, nw, self.live, seg, self.steps))
        kernels.launch("copy_async_launch", self._slot(0), self.live, 4)
        self.events[0].record()

    def loop(self):
        """The pool loop of `render_pool_fused` on the graphs: before step
        k >= LIVE_LAG, the count of step k - LIVE_LAG (0 ends the loop).
        Returns the (segments, steps, scatters) tensors."""
        k = 1
        while True:
            if k >= fs.LIVE_LAG:
                s = k % fs.LIVE_LAG
                fs._wait(self.events[s])
                if self.live_host[s] == 0:
                    break
            with spans.span("pool.launch"):
                self.graphs[(k - 1) % 2].replay()
                self.events[k % fs.LIVE_LAG].record()
                kernels.count_all(self.counted)
            k += 1
        return self.state[(k - 1) % 2][3], self.steps, self.scatters


class StepGraphs:
    """The fused pool's captured steps, kept between calls: per device and
    stream, the entries of the latest PER_STREAM keys (`key`), each a
    `_StepGraph` with its workspace. A call takes a free entry of its key
    (`take`), capturing one when the key has none or another call holds
    every one, and replays it each turn. `captured` counts the entries
    captured (a pair of graphs each), `replayed` the replays."""

    PER_STREAM = 2

    def __init__(self):
        self._lock = threading.Lock()
        # (device, stream) -> OrderedDict(rest of the key -> [entries]).
        self._entries = {}
        self.captured = 0
        self.replayed = 0

    @staticmethod
    def key(tables: fs.FusedTables, sp: fs.StepParams, p: int, device,
            stream) -> tuple:
        """What a captured step is made for: the device, the stream, the
        tables (their cache entry), the pool size and every field of sp
        but the seed, the sample offset and the AOV budget."""
        return (device, stream, id(tables), p,
                sp._replace(seed=0, sample_offset=0, aux=0))

    def take(self, tables: fs.FusedTables, sp: fs.StepParams,
             p: int) -> _StepGraph:
        """This call's captured step on the current stream, locked for it
        (the call releases `entry.lock`): a free entry of its key, or one
        captured now (the span `pool.capture`). Drops the stream's oldest
        keys past PER_STREAM that no call holds."""
        dev = tables.rectab.device
        key = self.key(tables, sp, p, dev,
                       torch.cuda.current_stream(dev).cuda_stream)
        with self._lock:
            lru = self._entries.get(key[:2])
            if lru is not None and key[2:] in lru:
                lru.move_to_end(key[2:])
                for entry in lru[key[2:]]:
                    if entry.lock.acquire(blocking=False):
                        return entry
        entry = _StepGraph(tables, sp, p, dev)
        entry.lock.acquire()
        with spans.span("pool.capture"):
            entry.capture(self)
        dropped = []
        with self._lock:
            lru = self._entries.setdefault(key[:2], collections.OrderedDict())
            lru.setdefault(key[2:], []).append(entry)
            lru.move_to_end(key[2:])
            for old in list(lru)[:max(0, len(lru) - self.PER_STREAM)]:
                if not any(e.lock.locked() for e in lru[old]):
                    dropped.extend(lru.pop(old))
        if dropped:
            # Their last copies to pinned memory may still be queued on
            # this stream: let them land before that memory is reused.
            torch.cuda.current_stream(dev).synchronize()
        return entry


cache = StepGraphs()


def eager_loop(tables, state, aparams, bparams, sp: fs.StepParams, acc):
    """The pool loop launch by launch (the CPU's): state = initial_state's
    six tensors. Returns the (segments, steps, scatters) tensors."""
    state_f, state_i, next_work, live_count, segments, steps = state
    scatters = torch.zeros((1,), dtype=torch.int64, device=acc.device)
    lag = 1 if acc.device.type == "cpu" else fs.LIVE_LAG
    pending = collections.deque([fs._host_copy(live_count)])
    while True:
        if len(pending) >= lag:
            ev, live_host = pending.popleft()
            if ev is not None:
                fs._wait(ev)
            if int(live_host[0]) == 0:
                break
        # Steps after the pool drains are no-ops: nothing is live, nothing
        # spawns, nothing is added and the step count stays.
        with spans.span("pool.launch"):
            hits = k1.closest_hit(state_f[:6], fs.T_MIN, tables.scan)
            (state_f, state_i, next_work, segments, live_count,
             steps) = fs.shade_accumulate(
                tables, hits, state_f, state_i, next_work, segments, steps,
                aparams, bparams, sp, acc, scatters)
        pending.append(fs._host_copy(live_count))
    return segments, steps, scatters
