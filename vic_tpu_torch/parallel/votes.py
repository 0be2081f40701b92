"""The decisions a step takes over its whole batch, taken over every share
of a cell block split across devices.

Three loops of the step stop on a test over the whole batch (CLOSE_ENERGY's
pass loop, `model.py`; the finite-difference node sweep's count,
`physics/frozen_soil.py`; the batch-wide Brent around it,
`ops/rootfind.py`), as `vic_tpu`'s `jnp.max`/`jnp.any`/`jnp.all` reduce
over every device of its cell mesh. When the driver splits a block into
shares (`driver.run_simulation(devices=[...])`), each share runs its
records in a host thread of its own, and every such test is a vote of the
n shares: each share hands in its own batch's value, and every share takes
the same decision from all of them, in the same order as the one-device
run takes it.

`ShareGroup(n)` holds the n shares of a block; `group.member(i)` is share
i's handle, which the step keeps (`model.make_step(votes=...)`).

- The shares' threads take turns (`ShareGroup.running`): one share's host
  code runs at a time, as the one-thread interleave of the other
  configurations does, and a share hands the turn on while it waits, at a
  vote or for its device. Threads that ran side by side would pass
  Python's lock to and fro at every PyTorch call (about three times
  slower on the CPU).
- On the host, `Member.max_nan(x)` (the largest value, NaN if any is NaN,
  whatever order the shares arrive in) and `Member.any(b)` meet at a
  `threading.Barrier`. The values sit in two rows used by turns, so a share
  that has passed one vote can hand in the next before a slow share has
  read the last.
- On the card, K6 and K7 take their sweep and Brent votes inside their
  cooperative launch (`csrc/share_votes.cuh`): thread 0 of block 0 of each
  share publishes its share's vote to a word of mapped pinned host memory
  (`cudaHostAlloc`, mapped and portable; every device reads it at its host
  address), polls the other shares' words until each carries this vote's
  sequence number, and hands the combined decision to its grid. The words
  are allocated at the first kernel call that needs them
  (`Member.device_table`). A share's grid waits at its votes holding its
  blocks, so where shares share a card each takes its part of the
  co-resident blocks, and they launch only once every share's stream has
  drained (`Member.launch_table`): no other kernel then needs room on the
  card until the grids end.

`abort(exc)` wakes every waiter, host or device, with an error; a share's
kernel that waits longer than `timeout_s` for another share records an
error that its wrapper raises (`Member.settle`), naming the share and the
vote. Nothing falls back to a local decision. A group of one share is
never made: the one-device step takes `votes=None` and no path changes.
"""
from __future__ import annotations

import contextlib
import ctypes
import math
import threading

import numpy as np
import torch

# how long a share waits for the others at a vote before it gives up
VOTE_TIMEOUT_S = 60.0

# csrc/share_votes.cuh's error code of a vote that reached the time limit
# (the other, 2, of a vote that found the group aborted)
_TIMED_OUT = 1


class ShareAborted(RuntimeError):
    """A share's vote ended because another share's error aborted the
    group (`ShareGroup.error` holds that error)."""


class ShareGroup:
    """The n shares of one cell block, run side by side, one host thread
    each. devices: the shares' devices (share i on devices[i]); shares on
    one CUDA device divide its co-resident blocks between their cooperative
    grids (`Member.grid_divisor`)."""

    def __init__(self, n: int, devices=None,
                 timeout_s: float = VOTE_TIMEOUT_S):
        if n < 2:
            raise ValueError(f"a share group needs at least 2 shares, got "
                             f"{n}")
        self.n = n
        self.devices = ([torch.device(d) for d in devices]
                        if devices is not None else None)
        if self.devices is not None and len(self.devices) != n:
            raise ValueError(f"{len(self.devices)} devices for {n} shares")
        self.timeout_s = float(timeout_s)
        self.error = None          # the exception that aborted the group
        self._barrier = threading.Barrier(n)
        self._rows = ([None] * n, [None] * n)
        self._votes = [0] * n      # host votes each share has handed in
        self._lock = threading.Lock()
        self._turn = threading.Lock()
        self._holds = threading.local()   # .turn: this thread holds it
        self._words = None         # the device words, made at first use
        self._host = None

    @property
    def shares_a_card(self) -> bool:
        """Whether two shares of the group run on one CUDA device."""
        devs = [d for d in self.devices or () if d.type == "cuda"]
        return len(set(devs)) < len(devs)

    def member(self, i: int) -> "Member":
        if not 0 <= i < self.n:
            raise IndexError(f"share {i} of {self.n}")
        return Member(self, i)

    @contextlib.contextmanager
    def running(self):
        """The context a share's thread runs its records in: it holds the
        group's turn, but while it waits (`_waiting`)."""
        self._take_turn()
        try:
            yield
        finally:
            self._holds.turn = False
            self._turn.release()

    def _take_turn(self):
        # no time limit: the holder hands the turn on at its next wait or
        # when it ends, errors included
        self._turn.acquire()
        self._holds.turn = True

    @contextlib.contextmanager
    def _waiting(self):
        """The turn handed on while this thread waits, where it holds it."""
        held = getattr(self._holds, "turn", False)
        if held:
            self._holds.turn = False
            self._turn.release()
        try:
            yield
        finally:
            if held:
                self._take_turn()

    def run(self, jobs):
        """Each of `jobs` (job i share i's) in a host thread of its own, the
        threads taking turns (`running`); an exception in one aborts the
        group, which wakes the others' votes. Raises the first error that
        was not another share's abort."""
        errors = []

        def run(job):
            try:
                with self.running():
                    job()
            except BaseException as exc:    # re-raised below
                errors.append(exc)
                self.abort(exc)

        threads = [threading.Thread(target=run, args=(job,), daemon=True)
                   for job in jobs]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise next((e for e in errors
                        if not isinstance(e, ShareAborted)), errors[0])

    @property
    def taken(self) -> tuple:
        """The host votes each share has taken since the last restart."""
        return tuple(self._votes)

    def restart(self):
        """Every sequence from 0: host and device votes, errors. Only while
        no share is voting (between record chunks and cell blocks)."""
        if self.error is not None:
            raise RuntimeError("restart of an aborted share group") \
                from self.error
        self._votes = [0] * self.n
        self._rows = ([None] * self.n, [None] * self.n)
        if self._host is not None:
            self._host[:] = 0

    def abort(self, exc: BaseException):
        """Wakes every share waiting at a vote, on the host or in a kernel,
        with an error; the first exception is kept as `error`."""
        with self._lock:
            if self.error is None:
                self.error = exc
        if self._host is not None:
            self._host[2 * self.n] = 1
        self._barrier.abort()

    def close(self):
        """Frees the device words (a synchronising call: only once no
        kernel of the group runs)."""
        if self._words is not None:
            from ..kernels import build
            build.load().share_votes_free(ctypes.c_void_p(self._words))
            self._words = self._host = None

    # -- host votes --
    def _vote(self, i: int, value, combine):
        seq = self._votes[i]
        self._votes[i] = seq + 1
        row = self._rows[seq % 2]
        row[i] = value
        try:
            with self._waiting():
                self._barrier.wait(self.timeout_s)
        except threading.BrokenBarrierError:
            timeout = RuntimeError(
                f"share {i} of {self.n}: host vote {seq} timed out after "
                f"{self.timeout_s} s waiting for the other shares")
            with self._lock:
                first = self.error is None
            if first:
                self.abort(timeout)
            if self.error is timeout:
                raise timeout from None
            raise ShareAborted(f"share {i} of {self.n}: host vote {seq} "
                               f"ended by the group's abort: "
                               f"{self.error!r}") from self.error
        return combine(row)

    # -- device words --
    def _device_words(self):
        """The group's mapped pinned words, allocated at first use: two
        rows of n vote slots, the abort word, each share's vote count, each
        share's error (csrc/share_votes.cuh)."""
        with self._lock:
            if self._words is None:
                from ..kernels import build
                n_words = 4 * self.n + 1
                ptr = ctypes.c_void_p()
                err = build.load().share_votes_alloc(n_words,
                                                     ctypes.byref(ptr))
                if err != 0:
                    raise RuntimeError("share votes: cudaHostAlloc of the "
                                       f"vote words failed (CUDA error "
                                       f"{err})")
                self._host = np.ctypeslib.as_array(
                    ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint64)),
                    shape=(n_words,))
                self._host[:] = 0
                self._host[2 * self.n] = int(self.error is not None)
                self._words = ptr.value
        return self._words


class Member:
    """Share `index` of a ShareGroup: the handle a share's step votes
    through."""

    def __init__(self, group: ShareGroup, index: int):
        self.group = group
        self.index = index

    def max_nan(self, x: float) -> float:
        """The largest of the shares' x, NaN if any share's x is NaN."""
        return self.group._vote(self.index, float(x), _max_nan)

    def any(self, b: bool) -> bool:
        """Whether any share's b is true."""
        return self.group._vote(self.index, bool(b), any)

    def launch_table(self):
        """The C group table of this share's next K6 or K7 launch
        (`device_table`), once the share may launch: where shares of the
        group share a card, when this share's stream has drained and every
        share stands at its launch (a host vote), so the card then holds
        the shares' cooperative grids alone. A kernel of one share queued
        behind another share's spinning grid could otherwise find no room
        on the card and hold back its own share's grid (a deadlock that
        PERF.md records)."""
        g = self.group
        table = self.device_table()
        if g.shares_a_card:
            with g._waiting():
                torch.cuda.current_stream().synchronize()
            g._vote(self.index, None, _none)
        return table

    @property
    def grid_divisor(self) -> int:
        """The shares of the group on this share's device: each takes that
        share of the device's co-resident blocks for its cooperative grid,
        so the grids of the shares of one card are resident together."""
        devs = self.group.devices
        if devs is None:
            return 1
        return sum(d == devs[self.index] for d in devs)

    def device_table(self):
        """The C group table of K6 and K7 (csrc/share_votes.cuh
        fill_share_votes): the words' address, this share, the share count,
        the grid divisor and the time limit in ns, as int64."""
        g = self.group
        return np.array([g._device_words(), self.index, g.n,
                         self.grid_divisor, int(g.timeout_s * 1e9)],
                        np.int64)

    def settle(self, name: str):
        """After a kernel launch with this share's table on the current
        stream: waits for it, handing the turn on, and raises, naming the
        share and the vote, if it recorded an error (the time limit, or the
        group's abort)."""
        g = self.group
        event = torch.cuda.Event()
        event.record()
        with g._waiting():
            event.synchronize()
        word = int(g._host[3 * g.n + 1 + self.index])
        if word == 0:
            return
        seq, code, other = word >> 32, (word >> 16) & 0xffff, word & 0xffff
        where = f"{name}: share {self.index} of {g.n}, device vote {seq}"
        if code != _TIMED_OUT:
            raise ShareAborted(f"{where}: ended by the group's abort "
                               f"({g.error!r})")
        exc = RuntimeError(f"{where}: timed out after {g.timeout_s} s "
                           f"waiting for share {other}")
        g.abort(exc)
        raise exc


def _none(values):
    return None


def _max_nan(values):
    if any(math.isnan(v) for v in values):
        return math.nan
    return max(values)
