"""A cache, shared by the test workers of one session, for the reference
results the port's tests compare against. It holds no tests.

The suite runs under pytest-xdist with `--dist load`: the tests of one
file are dealt to several worker processes, and each rebuilds the file's
module fixtures. The reference's results (interpret-mode traversals,
numpy BVH builds, renders) take seconds to tens of seconds each, so
`cached` computes each once per session: the first worker to ask takes a
`fcntl.flock` lock on the entry, computes it and stores it with
`np.savez`; the others wait on the lock and load it (`cached_all` first
takes the entries no other worker holds). A wait is bounded: after
LOCK_WAIT_S the waiter computes the entry itself, and `os.replace` keeps
the store atomic whoever writes last. Entries live in the
directory all workers of the session share (the parent of each worker's
base temporary directory; the base directory itself without xdist), and
are keyed by a hash of the inputs that determine them.

Its one test holds the bounded wait.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import sys
import time
from typing import Callable, Dict, List, Tuple

import numpy as np


def _feed(h, x) -> None:
    """Hash x: arrays by dtype, shape and bytes; dicts, tuples and lists
    element by element; anything else by its repr."""
    if isinstance(x, dict):
        for k in sorted(x):
            h.update(repr(k).encode())
            _feed(h, x[k])
    elif isinstance(x, (tuple, list)):
        h.update(f"seq{len(x)}".encode())
        for v in x:
            _feed(h, v)
    elif isinstance(x, np.ndarray) or hasattr(x, "__array__"):
        a = np.ascontiguousarray(np.asarray(x))
        h.update(f"{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())
    else:
        h.update(repr(x).encode())


def key_of(*inputs) -> str:
    h = hashlib.sha256()
    for x in inputs:
        _feed(h, x)
    return h.hexdigest()[:20]


def cache_dir(tmp_path_factory) -> str:
    base = tmp_path_factory.getbasetemp()
    shared = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    path = os.path.join(str(shared), "torch_port_cache")
    os.makedirs(path, exist_ok=True)
    return path


def cached(tmp_path_factory, name: str, inputs, compute: Callable[[], Dict[str, np.ndarray]]
           ) -> Dict[str, np.ndarray]:
    """compute() (a dict of numpy arrays), once per session for these
    inputs; every caller gets the arrays as stored."""
    return cached_all(tmp_path_factory, [(name, inputs, compute)])[0]


def cached_all(tmp_path_factory, entries: List[Tuple[str, object, Callable]]
               ) -> List[Dict[str, np.ndarray]]:
    """`cached` for several (name, inputs, compute) entries. A worker takes
    first the entries no other worker is computing, so two workers that
    ask for the same entries at once share the work instead of waiting."""
    stems = [os.path.join(cache_dir(tmp_path_factory), f"{name}-{key_of(name, inputs)}")
             for name, inputs, _ in entries]
    todo = list(range(len(entries)))
    while todo:
        for blocking in (False, True):
            k = next((k for k in todo if _fill(stems[k], entries[k][2], blocking)), None)
            if k is not None:
                todo.remove(k)
                break
    out = []
    for stem in stems:
        with np.load(stem + ".npz") as z:
            out.append({k: z[k] for k in z.files})
    return out


# How long a worker waits for an entry another worker holds before it
# computes the entry itself: longer than any entry takes (the slowest, a
# reference render, takes under two minutes on a loaded machine), so a
# holder that is slow, stuck or gone costs a waiter this much at most
LOCK_WAIT_S = 300.0
_POLL_S = 0.25


def _store(stem: str, compute: Callable) -> None:
    """Compute the entry and put it in place atomically (os.replace), under
    a temporary name of this process's own."""
    out = {k: np.asarray(v) for k, v in compute().items()}
    tmp = f"{stem}.{os.getpid()}.tmp.npz"
    np.savez(tmp, **out)
    os.replace(tmp, stem + ".npz")


def _fill(stem: str, compute: Callable, blocking: bool) -> bool:
    """Make the entry at stem if it is not there; False if it is locked by
    another worker and blocking is False. Blocking, wait for the lock at
    most LOCK_WAIT_S, then make the entry without it."""
    with open(stem + ".lock", "w") as lock:
        deadline = time.monotonic() + (LOCK_WAIT_S if blocking else 0.0)
        while True:
            try:
                fcntl.flock(lock, fcntl.LOCK_EX | fcntl.LOCK_NB)
                break
            except BlockingIOError:
                if os.path.exists(stem + ".npz"):
                    return True
                if time.monotonic() >= deadline:
                    if not blocking:
                        return False
                    _store(stem, compute)
                    return True
                time.sleep(_POLL_S)
        if not os.path.exists(stem + ".npz"):
            _store(stem, compute)
        return True


def test_wait_on_a_held_entry_is_bounded(tmp_path, monkeypatch):
    """A waiter whose entry another holder keeps locked computes it itself
    after LOCK_WAIT_S; a non-blocking ask returns at once."""
    monkeypatch.setattr(sys.modules[__name__], "LOCK_WAIT_S", 0.5)
    stem = str(tmp_path / "entry")
    with open(stem + ".lock", "w") as held:
        fcntl.flock(held, fcntl.LOCK_EX)  # another open file: another holder
        t0 = time.monotonic()
        assert not _fill(stem, lambda: {"x": np.arange(3)}, blocking=False)
        assert _fill(stem, lambda: {"x": np.arange(3)}, blocking=True)
        assert 0.5 <= time.monotonic() - t0 < 5.0
    with np.load(stem + ".npz") as z:
        assert z["x"].tolist() == [0, 1, 2]
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]
