"""Columnar page-mapped FTL storage model (paper §2.5, ROADMAP FTL item).

The constant-bandwidth :class:`~repro_torch.core.device_model.SSDModel` *assumes*
the paper's §2.5 claim — that log-structured buffering makes redirected
random writes cheap on flash.  This module models the mechanism so the
claim can be *measured*: a page-mapped flash translation layer with

* **columnar mapping state** — logical→physical (``l2p``) and
  physical→logical (``p2l``) int32 arrays plus a per-block valid-page
  count, mirroring the cache/channel/NAND split of FTL-SIM; no
  per-page Python objects anywhere.
* **N-channel striping** — a page program occupies one channel for
  ``t_prog`` seconds; with ``n_channels`` interleaved dies the device
  sustains one page per ``t_prog / n_channels`` (``t_page``).  The
  default ``t_prog`` is calibrated so the nominal striped bandwidth
  equals the constant model's 380 MB/s.
* **watermark-triggered greedy GC** — writes consume a free-block
  queue; when it dips below ``gc_low_blocks`` the FTL relocates the
  still-valid pages of minimum-valid sealed blocks (greedy victim
  choice) and erases them until ``gc_high_blocks`` are free again —
  the free-block-watermark dynamics of unsynchronized GC.  Relocations are charged to the request that tripped the
  watermark.
* **measured write amplification** — ``wa = (host_pages +
  relocated_pages) / host_pages``.  Sequential log appends plus
  whole-region ``trim`` on flush completion keep WA ≈ 1 (SSDUP+'s log
  store); in-place random writes at high occupancy drive WA up.

Batch-size independence (the engine-parity contract): GC fires at exact
request boundaries.  :meth:`charge_write` slices a request batch into
GC epochs — the maximal prefix that cannot trip the low watermark is
served vectorized, the tripping request is served and pays the GC time,
then the scan resumes — so charging requests one at a time (the
per-request engine) and in arbitrary batches (the batched engine)
produces bit-identical times and identical device state.
"""

from __future__ import annotations

from collections import deque
from typing import Any

import numpy as np

from ..analysis import sanitize as _sanitize


class FTLModel:
    """Page-mapped FTL with N-channel striping and watermark greedy GC.

    Implements the :class:`~repro_torch.core.device_model.StorageModel`
    protocol (``stateful=True``): :meth:`charge_write` consumes LBAs and
    mutates mapping state; :meth:`trim` invalidates a flushed region's
    pages (what keeps the log store's WA at ~1).
    """

    stateful: bool = True
    name: str = "ftl"

    def __init__(
        self,
        logical_bytes: int,
        page_size: int = 4096,
        pages_per_block: int = 256,
        n_channels: int = 8,
        overprovision: float = 0.25,
        t_prog: float | None = None,
        t_erase: float = 2.0e-3,
        read_bw: float = 450e6,
        gc_low_blocks: int = 4,
        gc_high_blocks: int = 8,
    ):
        if logical_bytes <= 0:
            raise ValueError("logical_bytes must be positive")
        if page_size <= 0 or pages_per_block <= 0 or n_channels <= 0:
            raise ValueError("page_size/pages_per_block/n_channels must be positive")
        if overprovision < 0.0:
            raise ValueError("overprovision must be >= 0")
        if not 2 <= gc_low_blocks < gc_high_blocks:
            raise ValueError(
                "need 2 <= gc_low_blocks < gc_high_blocks "
                f"(got {gc_low_blocks}/{gc_high_blocks})"
            )
        if t_prog is None:
            # nominal striped write bandwidth == the constant model's 380 MB/s
            t_prog = n_channels * page_size / 380e6
        if t_prog <= 0 or t_erase < 0 or read_bw <= 0:
            raise ValueError("non-positive device timing parameter")
        self.logical_bytes = int(logical_bytes)
        self.page_size = int(page_size)
        self.pages_per_block = int(pages_per_block)
        self.n_channels = int(n_channels)
        self.overprovision = float(overprovision)
        self.t_prog = float(t_prog)
        self.t_erase = float(t_erase)
        self.read_bw = float(read_bw)
        self.gc_low_blocks = int(gc_low_blocks)
        self.gc_high_blocks = int(gc_high_blocks)

        ps, ppb = self.page_size, self.pages_per_block
        self.num_logical_pages = -(-self.logical_bytes // ps)
        logical_blocks = -(-self.num_logical_pages // ppb)
        spare = max(
            self.gc_high_blocks + 2,
            int(np.ceil(logical_blocks * self.overprovision)),
        )
        self.num_blocks = logical_blocks + spare
        self.total_pages = self.num_blocks * ppb

        # columnar mapping state (int32: page counts stay < 2^31)
        self._l2p = np.full(self.num_logical_pages, -1, dtype=np.int32)
        self._p2l = np.full(self.total_pages, -1, dtype=np.int32)
        self._valid = np.zeros(self.num_blocks, dtype=np.int32)
        self._sealed = np.zeros(self.num_blocks, dtype=bool)
        self._free: deque[int] = deque(range(1, self.num_blocks))
        self._open = 0  # block receiving the write frontier
        self._fp = 0  # next unwritten page slot in the open block

        # conservation ledgers (sanitize_check invariants)
        self._valid_total = 0
        self._invalid_pages = 0
        self.host_bytes = 0
        self.host_pages = 0
        self.reloc_pages = 0
        self.trimmed_pages = 0
        self.erases = 0
        self.gc_runs = 0
        self.last_t = 0.0

    # -- derived timing/occupancy ----------------------------------------
    @property
    def t_page(self) -> float:
        """Seconds per page program with all channels interleaved."""

        return self.t_prog / self.n_channels

    @property
    def write_bw(self) -> float:
        """Nominal (GC-free) striped write bandwidth, bytes/s."""

        return self.n_channels * self.page_size / self.t_prog

    @property
    def free_pages(self) -> int:
        return (self.pages_per_block - self._fp) + self.pages_per_block * len(
            self._free
        )

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def live_pages(self) -> int:
        return self._valid_total

    @property
    def wa(self) -> float:
        """Measured write amplification: NAND pages per host page."""

        if self.host_pages == 0:
            return 1.0
        return (self.host_pages + self.reloc_pages) / self.host_pages

    # -- StorageModel protocol -------------------------------------------
    def write_time(self, nbytes: int) -> float:
        """Nominal (stateless) write estimate at the striped bandwidth."""

        return nbytes / self.write_bw

    def read_time(self, nbytes: int) -> float:
        return nbytes / self.read_bw

    def charge_write(
        self,
        offsets: np.ndarray | None,
        sizes: np.ndarray,
        t: float = 0.0,
    ) -> np.ndarray:
        """Service times of a request batch, mutating device state.

        Accuracy contract: batch-size independent — charging the same
        request sequence one call per request or in one call yields
        bit-identical times and identical mapping/ledger state (GC
        epochs are cut at exact request boundaries).
        """

        if offsets is None:
            raise ValueError(
                "FTLModel.charge_write needs per-request offsets (LBAs); "
                "only the stateless constant backend accepts offsets=None"
            )
        off = np.asarray(offsets, dtype=np.int64)
        szs = np.asarray(sizes, dtype=np.int64)
        n = len(szs)
        times = np.zeros(n, dtype=np.float64)
        if n == 0:
            return times
        if len(off) != n:
            raise ValueError(f"{len(off)} offsets for {n} sizes")
        if bool(np.any(szs < 0)) or bool(np.any(off < 0)) or bool(
            np.any(off + szs > self.logical_bytes)
        ):
            raise ValueError(
                "write outside the FTL's logical address space "
                f"[0, {self.logical_bytes})"
            )
        ps, ppb = self.page_size, self.pages_per_block
        p0 = off // ps
        pcnt = (off + szs + ps - 1) // ps - p0
        pcnt = np.where(szs > 0, pcnt, 0)
        self.host_bytes += int(szs.sum())
        self.last_t = float(t)

        i = 0
        while i < n:
            if len(self._free) >= self.gc_low_blocks:
                # pages servable before any request can trip the low
                # watermark: the open block's remainder plus every free
                # block above the watermark
                headroom = (ppb - self._fp) + (
                    len(self._free) - self.gc_low_blocks
                ) * ppb
                cum = np.cumsum(pcnt[i:])
                j = int(np.searchsorted(cum, headroom, side="right"))
                if j >= n - i:  # no trigger in the rest of the batch
                    self._serve(p0[i:], pcnt[i:], times[i:])
                    return times
                stop = i + j + 1  # include the tripping request
            else:
                stop = i + 1  # already below the watermark: GC per request
            self._serve(p0[i:stop], pcnt[i:stop], times[i:stop])
            times[stop - 1] += self._collect()
            self.gc_runs += 1
            i = stop
        return times

    def trim(self, offset: int, nbytes: int) -> None:
        """Invalidate the latest versions of fully-covered pages.

        Called by the pipeline when a flushed region's content is no
        longer needed on flash — this is what keeps the log store's
        measured WA at ~1 (GC finds whole blocks invalid).
        """

        if nbytes <= 0:
            return
        ps = self.page_size
        first = -(-offset // ps)
        last = min(offset + nbytes, self.logical_bytes) // ps
        if last <= first:
            return
        lp = np.arange(first, last, dtype=np.int64)
        old = self._l2p[lp]
        m = old >= 0
        cnt = int(np.count_nonzero(m))
        if cnt:
            stale = old[m].astype(np.int64)
            self._p2l[stale] = -1
            self._valid -= np.bincount(
                stale // self.pages_per_block, minlength=self.num_blocks
            ).astype(np.int32)
            self._l2p[lp[m]] = -1
            self._valid_total -= cnt
            self._invalid_pages += cnt
            self.trimmed_pages += cnt

    def clone(self) -> "FTLModel":
        """Fresh same-config FTL (per-node copies in fleet runs)."""

        return FTLModel(
            logical_bytes=self.logical_bytes,
            page_size=self.page_size,
            pages_per_block=self.pages_per_block,
            n_channels=self.n_channels,
            overprovision=self.overprovision,
            t_prog=self.t_prog,
            t_erase=self.t_erase,
            read_bw=self.read_bw,
            gc_low_blocks=self.gc_low_blocks,
            gc_high_blocks=self.gc_high_blocks,
        )

    def degraded(self, factor: float) -> "FTLModel":
        """Scale device bandwidths by ``factor`` (< 1 degrades) IN PLACE,
        preserving mapping state and WA ledgers; returns self."""

        if not factor > 0.0:
            raise ValueError(f"degradation factor must be > 0, got {factor!r}")
        self.t_prog = self.t_prog / factor
        self.t_erase = self.t_erase / factor
        self.read_bw = self.read_bw * factor
        return self

    def config_fingerprint(self) -> dict[str, Any]:
        """Config identity embedded in golden fixtures: replaying a
        fixture under a different backend/config fails loudly."""

        return {
            "name": self.name,
            "logical_bytes": int(self.logical_bytes),
            "page_size": int(self.page_size),
            "pages_per_block": int(self.pages_per_block),
            "n_channels": int(self.n_channels),
            "overprovision": float(self.overprovision),
            "t_prog": float(self.t_prog),
            "t_erase": float(self.t_erase),
            "read_bw": float(self.read_bw),
            "gc_low_blocks": int(self.gc_low_blocks),
            "gc_high_blocks": int(self.gc_high_blocks),
        }

    def stats(self) -> dict[str, float]:
        """Occupancy/WA snapshot for benchmarks and diagnostics."""

        return {
            "wa": float(self.wa),
            "host_bytes": float(self.host_bytes),
            "host_pages": float(self.host_pages),
            "reloc_pages": float(self.reloc_pages),
            "trimmed_pages": float(self.trimmed_pages),
            "erases": float(self.erases),
            "gc_runs": float(self.gc_runs),
            "free_blocks": float(len(self._free)),
            "live_fraction": float(self._valid_total / self.total_pages),
        }

    # -- conservation ledgers (sanitize mode) ----------------------------
    def sanitize_check(self) -> None:
        """FTL conservation ledgers; raises
        :class:`~repro_torch.analysis.sanitize.SanitizerError` on violation."""

        valid_sum = int(self._valid.sum())
        _sanitize.check(
            valid_sum == self._valid_total,
            "per-block valid counts sum to %d but the ledger says %d",
            valid_sum, self._valid_total,
        )
        _sanitize.check(
            self._valid_total + self._invalid_pages + self.free_pages
            == self.total_pages,
            "page conservation broken: valid=%d + invalid=%d + free=%d "
            "!= total=%d",
            self._valid_total, self._invalid_pages, self.free_pages,
            self.total_pages,
        )
        mapped = int(np.count_nonzero(self._l2p >= 0))
        _sanitize.check(
            mapped == self._valid_total,
            "l2p maps %d pages but %d physical pages are valid",
            mapped, self._valid_total,
        )
        _sanitize.check(
            (self.host_pages + self.reloc_pages) * self.page_size
            >= self.host_bytes,
            "physical NAND writes (%d pages) cannot cover host bytes (%d)",
            self.host_pages + self.reloc_pages, self.host_bytes,
        )

    # -- internals --------------------------------------------------------
    def _alloc(self, k: int) -> np.ndarray:
        """Allocate ``k`` physical pages at the write frontier."""

        out = np.empty(k, dtype=np.int64)
        ppb = self.pages_per_block
        i = 0
        while i < k:
            if self._fp == ppb:
                self._sealed[self._open] = True
                if not self._free:
                    raise RuntimeError(
                        "FTL out of physical space (GC cannot reclaim "
                        "enough invalid pages)"
                    )
                self._open = self._free.popleft()
                self._fp = 0
            take = min(ppb - self._fp, k - i)
            base = self._open * ppb + self._fp
            out[i:i + take] = np.arange(base, base + take, dtype=np.int64)
            self._fp += take
            i += take
        return out

    def _serve(self, p0: np.ndarray, pcnt: np.ndarray, out: np.ndarray) -> None:
        """Serve one GC-free request segment: program its pages and write
        per-request channel-striped program times into ``out``."""

        out[:] = pcnt.astype(np.float64) * self.t_page
        total = int(pcnt.sum())
        if total == 0:
            return
        base = np.repeat(np.cumsum(pcnt) - pcnt, pcnt)
        lpns = np.repeat(p0, pcnt) + np.arange(total, dtype=np.int64) - base
        self._program(lpns)

    def _program(self, lpns: np.ndarray) -> None:
        """Program one page per element of ``lpns`` (in order); the LAST
        write of a duplicated lpn wins, earlier copies are immediately
        superseded (they still consume a program and a page)."""

        total = len(lpns)
        ppns = self._alloc(total)
        if total == 1 or bool(np.all(lpns[1:] > lpns[:-1])):
            # log-append fast path: strictly increasing => no duplicates
            uniq, final, stale_new = lpns, ppns, None
        else:
            order = np.argsort(lpns, kind="stable")
            sl = lpns[order]
            last = np.ones(total, dtype=bool)
            last[:-1] = sl[1:] != sl[:-1]
            uniq = sl[last]
            sp = ppns[order]
            final = sp[last]
            stale_new = sp[~last]
        old = self._l2p[uniq]
        old_live = old[old >= 0].astype(np.int64)
        self._p2l[ppns] = lpns.astype(np.int32)
        self._valid += np.bincount(
            ppns // self.pages_per_block, minlength=self.num_blocks
        ).astype(np.int32)
        self._valid_total += total
        stale = (
            old_live if stale_new is None
            else np.concatenate([old_live, stale_new])
        )
        cnt = len(stale)
        if cnt:
            self._p2l[stale] = -1
            self._valid -= np.bincount(
                stale // self.pages_per_block, minlength=self.num_blocks
            ).astype(np.int32)
            self._valid_total -= cnt
            self._invalid_pages += cnt
        self._l2p[uniq] = final.astype(np.int32)
        self.host_pages += total

    def _collect(self) -> float:
        """Greedy GC: relocate + erase minimum-valid sealed blocks until
        ``gc_high_blocks`` are free; returns the channel-striped time."""

        secs = 0.0
        ppb = self.pages_per_block
        while len(self._free) < self.gc_high_blocks:
            cands = np.flatnonzero(self._sealed)
            if not len(cands):
                break  # nothing sealed yet: GC cannot help
            vi = int(cands[np.argmin(self._valid[cands])])
            v = int(self._valid[vi])
            if v >= ppb:
                break  # every sealed block fully valid: no space to gain
            if v:
                span = self._p2l[vi * ppb:(vi + 1) * ppb]
                live = np.flatnonzero(span >= 0)
                lp = span[live].astype(np.int64)
                new = self._alloc(v)
                span[live] = -1
                self._valid[vi] = 0
                self._p2l[new] = lp.astype(np.int32)
                self._l2p[lp] = new.astype(np.int32)
                self._valid += np.bincount(
                    new // ppb, minlength=self.num_blocks
                ).astype(np.int32)
                self._invalid_pages += v  # the relocated-from slots
                self.reloc_pages += v
                secs += v * self.t_page
            # erase: a sealed victim's ppb written pages are all invalid now
            self._sealed[vi] = False
            self._free.append(vi)
            self._invalid_pages -= ppb
            self.erases += 1
            secs += self.t_erase / self.n_channels
        return secs

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"FTLModel(logical={self.logical_bytes >> 20}MiB, "
            f"blocks={self.num_blocks}, free={len(self._free)}, "
            f"wa={self.wa:.3f})"
        )
