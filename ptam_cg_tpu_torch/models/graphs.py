"""CUDA graphs of static buffers, with conditional nodes in them: what the
engine's programs (``models/programs.py``), the MapMaker's programs
(``models/mapmaker.py``) and BA's LM chunk (``models/bundle.py``) are
built on.

A ``jax.jit`` program is one dispatch; its counterpart on the card is a
CUDA graph. A ``Program`` owns static input buffers and runs a function
on them: on the card it is captured once (``Graph``: a warm-up on a side
stream, then the capture, in thread-local mode because the engine's
mapping worker launches on another thread meanwhile) and every call
replays it; on the CPU, or with ``graphs=False`` on the card, the same
function runs eagerly on the same buffers and its outputs are copied into
the first call's, so they are overwritten as a replay's are. A failed
capture raises: nothing falls back to eager by itself.

Captures on several threads run at once (the engine's tracking thread
and its mapping worker each capture what they meet), each in its own
memory pool, on streams of its own thread, and no thread waits for
another's capture. What CUDA refuses while any stream captures is a
device-wide sync: ``synchronize`` waits until no capture is under way.
Work on the legacy default stream (the tracking thread's, by default)
beside a capture is legal, since every stream that captures is created
non-blocking. A graph shares its memory pool only with graphs that never
run at the same time as it: the MapMaker's jobs share the MapMaker's
pool, and BA's chunk programs, which outlive their MapMaker
(``mapmaker.ChunkPrograms``), one pool for each thread that runs them,
owned by their cache.

Data-dependent control flow (JAX's ``lax.cond`` and ``while_loop``)
becomes ``if_block`` and ``loop``: under a capture they open a CUDA IF
or WHILE node (``csrc/graph_cond.cu``, built at the first capture) whose
body runs on the card when, or while, a bool tensor is true; in an eager
call they read the predicate on the host (or take a Python bool) and the
caller skips or repeats the body. A value the body computes for later
code is written into a tensor made before the block, so that a replay
that skips the body keeps the old one. In a warm-up every body runs
once, so that the capture meets no lazy library set-up. (cuSOLVER's
triangular solve, ``cholesky_solve``, cannot sit in a conditional body:
its graph fails to instantiate.)

The kernels' launch counts (``kernels/_build.py``) count Python calls of
their wrappers, and a replay makes none: a capture records the kernels
it launched by wrapper module (``_build.tally``), and each replay adds
them on the stream it replays on. Calls of the functions a caller counts
are recorded the same way (``note_call``) and added to ``replays``. A
conditional body runs on some replays only, or many times: its launches
and calls are recorded apart, the body adds one to a counter on the card
each time it runs, and ``settle_launches`` (a host read of the counters)
adds what ran since the last one. ``capturing()`` tells a caller's
counters that a call made now runs nothing: it is being captured.
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import threading
import time
import weakref

import numpy as np
import torch

from ptam_cg_tpu_torch.kernels import _build
from ptam_cg_tpu_torch.utils import spans
from ptam_cg_tpu_torch.utils import tree

Tensor = torch.Tensor

_LOCAL = threading.local()
_REPLAY_LOCK = threading.Lock()
#: Guards the count of captures under way in the process (any thread);
#: ``synchronize`` holds it across its device sync, so no capture starts
#: meanwhile. A capture holds it only to count itself in and out.
_CAPTURE_LOCK = threading.Lock()
_CAPTURES_DONE = threading.Condition(_CAPTURE_LOCK)
_under_way = 0
#: Whether Python's cyclic GC was on when the first capture under way
#: began (see ``_capture_under_way``).
_gc_was_enabled = False
#: Replays in this process, by the name of the function each replays (or
#: each call a capture recorded with ``note_call``).
replays: dict = {}
#: The same, by the name of the thread that replayed.
replays_by_thread: dict = {}
#: Graphs with conditional bodies that launch kernels or record calls.
_COUNTED = weakref.WeakSet()
#: Conditional bodies a graph may count.
MAX_COUNTED_BODIES = 256


#: The capture modes of ``cudaStreamCaptureMode``.
_THREAD_LOCAL = 1
#: Streams that capture conditional bodies, by (device index, thread):
#: one a nesting depth.
_BODY_STREAMS: dict = {}
_MAX_DEPTH = 4


def _cond_lib():
    lib = _build.load("graph_cond")
    if lib.graph_cond_begin.argtypes is None:
        lib.graph_cond_begin.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_ulonglong)]
        lib.graph_cond_set.argtypes = [ctypes.c_ulonglong, ctypes.c_void_p,
                                       ctypes.c_void_p]
        lib.graph_cond_end.argtypes = [ctypes.c_void_p]
        lib.graph_cond_stream_create.argtypes = [
            ctypes.POINTER(ctypes.c_void_p)]
        for fn in (lib.graph_cond_begin, lib.graph_cond_set,
                   lib.graph_cond_end, lib.graph_cond_stream_create):
            fn.restype = ctypes.c_int
    return lib


def _body_streams(device: torch.device) -> list:
    """Streams of this process's own (not of PyTorch's pool, which other
    threads' work shares) that capture this thread's conditional bodies,
    one a nesting depth; made before a capture."""
    key = (device.index, threading.get_ident())
    streams = _BODY_STREAMS.get(key)
    if streams is None:
        lib, streams = _cond_lib(), []
        with torch.cuda.device(device):
            for _ in range(_MAX_DEPTH):
                h = ctypes.c_void_p()
                _build.check(lib.graph_cond_stream_create(ctypes.byref(h)),
                             "graph_cond_stream_create")
                streams.append(torch.cuda.ExternalStream(h.value,
                                                         device=device))
        _BODY_STREAMS[key] = streams
    return streams


def on_card(device, graphs: bool) -> bool:
    """Whether a program on ``device`` runs as a CUDA graph: asked for,
    and on the card."""
    return graphs and torch.device(device).type == "cuda"


@contextlib.contextmanager
def _capture_under_way():
    """Count a capture in for ``synchronize`` (waiting out a sync in
    progress) and out at the end; and no collection of Python's cyclic
    garbage while any capture is under way: one may destroy an old CUDA
    graph, whose teardown a capturing thread is refused (its capture then
    fails)."""
    global _under_way, _gc_was_enabled
    with _CAPTURE_LOCK:
        if _under_way == 0:
            _gc_was_enabled = gc.isenabled()
        gc.disable()
        _under_way += 1
    try:
        yield
    finally:
        with _CAPTURE_LOCK:
            _under_way -= 1
            if _under_way == 0:
                if _gc_was_enabled:
                    gc.enable()
                _CAPTURES_DONE.notify_all()


def capturing() -> bool:
    """True while this thread captures a program."""
    return getattr(_LOCAL, "capturing", False)


def warming() -> bool:
    """True while this thread warms a program up before its capture."""
    return getattr(_LOCAL, "warming", False)


def device_predicates() -> bool:
    """True where a program's function takes the path it is captured on:
    in a capture, its warm-up, or ``emulate``."""
    return capturing() or warming() or getattr(_LOCAL, "emulating", False)


@contextlib.contextmanager
def _flag(name: str):
    setattr(_LOCAL, name, True)
    try:
        yield
    finally:
        setattr(_LOCAL, name, False)


@contextlib.contextmanager
def warm():
    """Run conditional bodies as a warm-up does: each one once, with no
    host read (a scan for host reads runs a program's function so)."""
    with _flag("warming"):
        yield


@contextlib.contextmanager
def emulate():
    """Run a program's function as a replay runs it, on any device: the
    path it is captured on, each ``if_block`` and ``loop`` reading its
    tensor predicate on the host as its node would on the card (tests on
    the CPU)."""
    with _flag("emulating"):
        yield


@contextlib.contextmanager
def if_block(pred):
    """``with if_block(pred) as go: if go: body``: ``body`` runs where
    ``pred`` (a 0-dim bool tensor, or a Python bool in an eager call) is
    true. Under a capture the body goes into a CUDA IF node on ``pred``
    (``go`` is True); in a warm-up ``go`` is True; in an eager call
    ``go`` is ``bool(pred)``, a host read for a tensor."""
    if warming():
        yield True
        return
    graph = getattr(_LOCAL, "graph", None)
    if graph is None:
        yield bool(pred)
        return
    graph._open_cond(pred, loop=False)
    try:
        yield True
    finally:
        graph._close_cond()


def loop(cond):
    """``for _ in loop(cond): body``: ``body`` runs while ``cond()`` (a
    0-dim bool tensor, or a Python bool in an eager call) is true, and
    ``body`` updates what ``cond`` returns. Under a capture the body goes
    once into a CUDA WHILE node, which tests ``cond()`` before each run on
    the card; in a warm-up the body runs once; in an eager call ``cond()``
    is read on the host before each run."""
    if warming():
        yield
        return
    graph = getattr(_LOCAL, "graph", None)
    if graph is None:
        while cond():
            yield
        return
    graph._open_cond(cond(), loop=True)
    try:
        yield
    finally:
        graph._close_cond(cond())


def note_call(name: str) -> None:
    """Record a call of the function ``name`` in the capture under way on
    this thread (nothing otherwise): each replay that runs it adds one to
    ``replays[name]``."""
    if capturing():
        _build.tally_key(name)


def _add_replays(name: str, thread: str, n: int = 1) -> None:
    with _REPLAY_LOCK:
        replays[name] = replays.get(name, 0) + n
        by = replays_by_thread.setdefault(thread, {})
        by[name] = by.get(name, 0) + n


def _count(tally: dict, stream: int, thread: str, n: int = 1) -> None:
    """Add ``n`` times a capture's tally: launches by wrapper module on
    ``stream``, calls by function name on ``thread``."""
    for key, k in tally.items():
        if isinstance(key, str):
            _add_replays(key, thread, k * n)
        else:
            _build.count_launches(key, stream, k * n)


def clone(obj):
    return tree.map_tensors(obj, Tensor.clone)


def fill(buf: Tensor, x) -> None:
    """Copy ``x`` (a tensor or a numpy array) into ``buf``, unless it is
    ``buf``. A host array goes to the card through pinned memory without
    a host sync."""
    if x is buf:
        return
    if not isinstance(x, Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    if x.device.type == "cpu" and buf.device.type == "cuda":
        buf.copy_(x.pin_memory(), non_blocking=True)
    else:
        buf.copy_(x)


def fill_tree(bufs, values) -> None:
    """``fill`` each tensor of ``bufs`` from the one in the same place of
    ``values`` (the same structure)."""
    for buf, x in zip(tree.tensors(bufs), tree.tensors(values)):
        fill(buf, x)


def pool_bytes(pool) -> int:
    """Bytes the caching allocator holds in the graph memory pool ``pool``
    (``torch.cuda.graph_pool_handle()``)."""
    pool = tuple(pool)
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s.get("segment_pool_id", ())) == pool)


class Graph:
    """``fn(*inputs)`` captured as a CUDA graph of the static tensors
    ``inputs``. A warm-up runs first on a side stream, on clones of the
    inputs (the function may write its inputs), with every conditional
    body run once;
    its kernels launch and count as the caller's. Then the capture, with
    ``capture_error_mode="thread_local"`` (another thread may launch, and
    capture, on its own streams meanwhile), records the kernels the
    wrappers launch; ``replay`` runs the graph on the current stream and
    returns the static outputs.

    ``inputs``: the static inputs, to fill before a replay.
    ``warm_s``: seconds of the warm-up on the host clock; ``capture_s``:
    of the capture and the instantiation (the ``graph.warm`` and
    ``graph.capture`` spans of ``utils/spans.py``). ``launches``:
    {kernel wrapper module or function name: launches or calls a
    replay}, outside conditional bodies; ``bodies``: the same for each
    conditional body
    that has any,
    and ``body_runs`` (int64 on the card) the times each body ran.
    ``n_if``, ``n_while``: IF and WHILE nodes. ``debug_path``: a file to
    write the captured graph to, as Graphviz DOT
    (``CUDAGraph.debug_dump``), for counting its nodes.
    ``pool``: a memory pool (``torch.cuda.graph_pool_handle()``) shared
    with graphs that never run at the same time as this one."""

    def __init__(self, fn, inputs, debug_path: str | None = None,
                 pool=None):
        dev = next(tree.tensors(inputs)).device
        self.device, self.inputs = dev, inputs
        self._streams = _body_streams(dev)
        caller = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(caller)
        t0 = time.time_ns()
        with _build.tally() as warm_tally, torch.cuda.stream(side), warm():
            fn(*clone(inputs))
        caller.wait_stream(side)
        t1 = time.time_ns()
        self.warm_s = (t1 - t0) / 1e9
        spans.add("graph.warm", t0, t1)
        # The warm-up's calls were counted as they ran.
        _count({k: n for k, n in warm_tally.items()
                if not isinstance(k, str)}, caller.cuda_stream,
               threading.current_thread().name)
        # A graph to dump is kept after its instantiation.
        keep = debug_path is not None
        self.graph = torch.cuda.CUDAGraph(keep_graph=keep)
        self.body_runs = torch.zeros(MAX_COUNTED_BODIES, dtype=torch.int64,
                                     device=dev)
        self.bodies, self._open, self.n_if, self.n_while = [], [], 0, 0
        self._thread_routed = False
        # Conditional bodies allocate from the graph's pool: name it here
        # (a graph's own pool id is not known until its capture ends).
        self.pool = torch.cuda.graph_pool_handle() if pool is None else pool
        t0 = time.time_ns()
        with _capture_under_way():
            _LOCAL.graph = self
            try:
                # ``torch.cuda.graph`` without its device sync and cache
                # release: a capture runs nothing, and the allocator's
                # cache serves the other thread's eager work meanwhile.
                with _build.tally() as self.launches, _flag("capturing"), \
                        torch.cuda.stream(side):
                    self.graph.capture_begin(
                        pool=self.pool, capture_error_mode="thread_local")
                    try:
                        self.outputs = fn(*inputs)
                    finally:
                        self.graph.capture_end()
            finally:
                _LOCAL.graph = None
        if keep:
            self.graph.instantiate()
        t1 = time.time_ns()
        self.capture_s = (t1 - t0) / 1e9
        spans.add("graph.capture", t0, t1)
        if keep:
            self.graph.debug_dump(debug_path)
        self._settled = [0] * len(self.bodies)
        self._where = None
        if self.bodies:
            _COUNTED.add(self)

    def _open_cond(self, pred: Tensor, loop: bool) -> None:
        """Open an IF (``loop``: WHILE) node on ``pred`` and capture what
        follows into its body, on a body stream whose allocations go to
        this graph's pool."""
        if not (isinstance(pred, Tensor) and pred.dtype == torch.bool
                and pred.numel() == 1 and pred.device == self.device):
            raise ValueError("a conditional node under a capture needs a "
                             f"one-element bool tensor on {self.device}, got "
                             f"{pred!r}")
        depth = len(self._open)
        if depth >= len(self._streams):
            raise RuntimeError(f"conditional nodes nested deeper than "
                               f"{depth}")
        body = self._streams[depth]
        if not self._thread_routed:
            # The capture sends the allocations of its own stream to the
            # pool; bodies capture on other streams, so from the first
            # conditional node on every allocation of this thread goes
            # there (a pool takes one routing at a time).
            torch._C._cuda_endAllocateToPool(self.device.index, self.pool)
            torch._C._cuda_beginAllocateCurrentThreadToPool(
                self.device.index, self.pool)
            self._thread_routed = True
        outer = torch._C._cuda_getCurrentRawStream(self.device.index)
        handle = ctypes.c_ulonglong()
        _build.check(_cond_lib().graph_cond_begin(
            outer, pred.contiguous().data_ptr(), body.cuda_stream,
            _THREAD_LOCAL, int(loop), ctypes.byref(handle)),
            "graph_cond_begin")
        self.n_if += not loop
        self.n_while += loop
        on_body = torch.cuda.stream(body)
        on_body.__enter__()
        tally = _build.tally()
        self._open.append((on_body, body, handle, tally, tally.__enter__()))

    def _close_cond(self, pred: Tensor | None = None) -> None:
        """End the innermost conditional body; a WHILE body (``pred``)
        loads its predicate again as it ends."""
        on_body, body, handle, tally, launched = self._open.pop()
        try:
            if launched:
                j = len(self.bodies)
                if j >= MAX_COUNTED_BODIES:
                    raise RuntimeError(f"more than {MAX_COUNTED_BODIES} "
                                       "counted conditional bodies in one "
                                       "graph")
                self.body_runs[j].add_(1)
                self.bodies.append(dict(launched))
            if pred is not None:
                _build.check(_cond_lib().graph_cond_set(
                    handle, pred.contiguous().data_ptr(), body.cuda_stream),
                    "graph_cond_set")
        finally:
            tally.__exit__(None, None, None)
            on_body.__exit__(None, None, None)
            _build.check(_cond_lib().graph_cond_end(body.cuda_stream),
                         "graph_cond_end")

    def replay(self, name: str | None = None):
        """Run the graph; count its kernels and calls outside conditional
        bodies on the current stream and thread and, with ``name``, one
        replay of that function. Counts of bodies that ran on another
        stream or thread are settled first."""
        where = (torch._C._cuda_getCurrentRawStream(self.device.index),
                 threading.current_thread().name)
        if self.bodies and self._where not in (None, where):
            self.settle()
        self._where = where
        self.graph.replay()
        _count(self.launches, *where)
        if name is not None:
            _add_replays(name, where[1])
        return self.outputs

    def settle(self) -> None:
        """Add the launches and calls of the conditional bodies that ran
        since the last settle (a device sync and a host read)."""
        if not self.bodies or self._where is None:
            return
        if self.device.type == "cuda":
            synchronize(self.device)
        runs = self.body_runs[:len(self.bodies)].tolist()
        for body, n, seen in zip(self.bodies, runs, self._settled):
            if n > seen:
                _count(body, *self._where, n=n - seen)
        self._settled = runs


def synchronize(device=None) -> None:
    """``torch.cuda.synchronize`` once no capture is under way in the
    process, and none starts until it returns: CUDA refuses a device-wide
    sync while any stream captures, and the engine's threads capture their
    programs as they meet them. Sync a stream or an event instead where
    that will do (the engine's tracking path never calls this)."""
    with _CAPTURES_DONE:
        _CAPTURES_DONE.wait_for(lambda: _under_way == 0)
        torch.cuda.synchronize(device)


def settle_launches() -> None:
    """``Graph.settle`` of every live graph with counted conditional
    bodies: the launch and call counts then include every body that
    ran."""
    for g in list(_COUNTED):
        g.settle()


class Program:
    """A function of static input buffers (``_inputs``, ``_fn``),
    replayed as a ``Graph`` on the card (``graphs``) and run eagerly
    otherwise. ``name``: the function a replay counts as a call of (None:
    none). ``pool``: the ``Graph``'s memory pool."""

    name = None

    def __init__(self, device, graphs: bool, debug_path: str | None = None,
                 pool=None):
        self.device = torch.device(device)
        self.graphs = on_card(self.device, graphs)
        self.debug_path = debug_path
        self.pool = pool
        self.graph = None
        self._outputs = None

    def will_capture(self) -> bool:
        """True if the next call captures."""
        return self.graphs and self.graph is None

    def _inputs(self):
        raise NotImplementedError

    def _fn(self, *inputs):
        raise NotImplementedError

    def run(self):
        """The function on the filled buffers: a replay on the card, an
        eager call otherwise, whose results are copied into the first
        call's, so that each call overwrites the last one's outputs as a
        replay does."""
        if not self.graphs:
            out = self._fn(*self._inputs())
            if self._outputs is None:
                self._outputs = out
            for buf, x in zip(tree.tensors(self._outputs), tree.tensors(out)):
                if buf is not x:
                    buf.copy_(x)
            return self._outputs
        self.capture()
        return self.graph.replay(self.name)

    def capture(self) -> None:
        """Capture the graph now, unless it exists: a warm-up on copies
        of the buffers and the capture, which run nothing on them."""
        if self.graph is None:
            self.graph = Graph(self._fn, self._inputs(), self.debug_path,
                               self.pool)


class Job(Program):
    """``fn(*inputs)`` as a ``Program``: the caller fills ``inputs`` (a
    tuple of static tensors or structures of them) and calls ``run``."""

    def __init__(self, label: str, fn, inputs: tuple, device, graphs: bool,
                 debug_path: str | None = None, pool=None):
        super().__init__(device, graphs, debug_path, pool)
        self.label, self.fn, self.inputs = label, fn, inputs

    def _inputs(self):
        return self.inputs

    def _fn(self, *inputs):
        return self.fn(*inputs)
