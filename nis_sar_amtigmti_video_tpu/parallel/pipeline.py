"""Stage-overlapping pipeline over a frame/batch stream.

The reference's VideoSAR campaign runs sim -> focus -> save strictly serially
per frame (sar_batch_sim.py:312-328): the GPU idles during every .npy write
and the host idles during every focus. On the device the same overlap falls out of
JAX's async dispatch — enqueueing batch k+1 returns immediately, so the only
thing that serialises stages is fetching batch k's result before dispatching
k+1. :func:`pipelined` removes exactly that serialisation: it keeps ``depth``
device computations in flight and blocks only on the *oldest* one, so device
compute (focus of k+1) overlaps host transfer + IO (fetch/spill of k). This
is the framework's pipeline-parallel component (SURVEY §2.10, "pipeline
parallel": stage overlapping across frames / double-buffered streams);
combine with :class:`~nis_sar_amtigmti_video_tpu.native.FrameSpiller` to
overlap the disk-write stage as well.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Iterable, Iterator, Optional, TypeVar

T = TypeVar("T")
R = TypeVar("R")


def pipelined(dispatch: Callable[[T], R], items: Iterable[T], *,
              depth: int = 2,
              fetch: Optional[Callable[[R], object]] = None) -> Iterator:
    """Map ``dispatch`` over ``items`` with ``depth`` results in flight.

    ``dispatch(item)`` should *enqueue* device work and return a handle
    (a jax Array under async dispatch). ``fetch(handle)``, if given, is the
    blocking host-side stage (e.g. ``utils.cplx.to_host``); it runs on the
    oldest handle while up to ``depth - 1`` newer ones are still computing.
    Results are yielded in input order. ``depth=1`` degrades to the serial
    loop; ``depth=2`` is classic double buffering.
    """
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    inflight: deque = deque()
    for x in items:
        inflight.append(dispatch(x))
        if len(inflight) > depth:
            h = inflight.popleft()
            yield fetch(h) if fetch is not None else h
    while inflight:
        h = inflight.popleft()
        yield fetch(h) if fetch is not None else h
