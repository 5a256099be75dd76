"""Serving runtime: batched decode with the NI-Balancer in the loop
(PyTorch port of ``repro.runtime.serve``).

The ``Server`` owns

* physical expert *slot* weights — ``(L, n_slots, d, f)`` rows, i.e. native
  experts + shadow-slot replicas over ``virtual_ep`` logical devices,
* the shared :class:`~repro_torch.parallel.placement.PlacementTable` — the
  single placement substrate read by the balancer (planning view) and the
  decode step (committed routing view, as tensors on the server's device),
* a :class:`~repro_torch.core.ni_balancer.BalancerState` fed by the
  per-step expert counts,
* a :class:`~repro_torch.runtime.migration_driver.MigrationDriver`
  executing balancer plans as live stepped migrations,
* a dense KV cache (the default), or a paged one with a host-side
  :class:`PagePool` allocator.

Every decode step: drain migrations (commit fully-copied replicas at the
step boundary, then issue this tick's weight-row slices) -> route ->
dispatch -> observe counts -> (Eq. 2 trigger) -> plan with Algorithm 1 ->
submit the plan to the driver. ``migration_slices=0`` keeps the
instantaneous whole-expert copy as the parity baseline.

Under a mesh (``ParallelCtx(mesh=...)``, one ``Server`` per rank) the
EP axis is the model axis: a rank keeps the slot rows
``sharding.slot_rows`` of the expanded weights (under ESP, every expert's
hidden-dim shard ``sharding.expert_hidden`` and no balancer), serves its
requests (``sharding.batch_rows``) on its shard of the dense cache or of
the paged pool (the pool's KV heads; every page), sums the step's expert
counts over its data group so that every rank observes the global counts
and plans the same migrations, and moves migration slices between ranks.
The methods speak of the global batch on every rank: token operands and
logits are ``(B, ...)``, a rank computes its rows and the logits are
all-gathered over the data group; slot numbers are global, and the
``PagePool`` allocator and the block tables are host state, the same on
every rank (each rank's device tables hold its rows). A batch-1 admission
prefill and the prefill lane's chunk run on every rank (replicated, as the
reference's ``chunk_specs``), so every rank's pool holds the admitted
request's pages for its KV heads. Snapshots under a mesh are not ported
yet, nor the ``zamba``, ``xlstm`` and ``encdec`` patterns under a mesh:
without one they serve their dense and recurrent caches, the balancer
idle (it runs for MoE only). Frontend-stub embeds ride ``prefill`` and
``generate``.

Device failures: ``mark_dead`` aborts or fast-forwards in-flight migration
slices, evacuates orphaned experts (placement table and weight rows) and
drops the dead device's replicas from the routing table; ``revive``
re-admits it with blank slot rows and seeds them through the stepped
migration driver. Under a mesh the rows move between ranks as migration
slices do, and only the rank that holds a revived device's slot rows
scrubs them. Stragglers: per-device step-time EMAs scale heats, draining
load away. Request-level serving (admission, preemption, faults) lives one
layer up in :mod:`repro_torch.runtime.scheduler`.

Chunked admission (``ServeConfig(prefill_chunk=C)``, paged): a
request's context is prefilled C tokens a tick by the decode step's prefill
lane, through a side block table (``begin_chunk_prefill`` ..
``finish_chunk_prefill``), so a long prompt never stalls the live batch.
``restore_snapshot`` rebuilds a server on a fresh process from a
:class:`~repro_torch.runtime.snapshot.ServerSnapshot` and the logical
params.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.core.ni_balancer import (
    BalancerState,
    evacuate,
    revival_plan,
    should_trigger,
    topology_aware_balance,
)
from repro_torch.device import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding
from repro_torch.parallel.collectives import all_gather_dim, validate_ep_chunks
from repro_torch.parallel.ctx import ParallelCtx
from repro_torch.parallel.placement import PlacementTable
from repro_torch.runtime.migration_driver import (
    MOE_WEIGHTS,
    MigrationDriver,
    copy_row_slice,
)


@dataclasses.dataclass
class ServeConfig:
    max_seq: int = 1024
    batch: int = 8
    slots_per_device: int = 2      # native + shadow capacity per device
    alpha: float = 0.5             # Eq. 2 imbalance threshold
    beta: float = 0.0              # Eq. 2 refractory (0 = non-invasive)
    ema: float = 0.8
    # Stepped migration: each planned migration copies its expert's weight
    # rows over this many decode ticks; 0 = instantaneous whole-expert copy.
    migration_slices: int = 4
    # Paged KV cache: shared page pool + per-request block tables (False =
    # one dense (B, max_seq or window, K, hd) cache per layer).
    paged: bool = False
    page_size: int = A.PAGE_SIZE
    pool_pages: int | None = None  # None = fully backed (batch * NB)
    # Virtual EP: spread the expert slots over this many logical devices so
    # replica routing and migration run for real on one process.
    virtual_ep: int | None = None
    # Chunked prefill: admission prefills run as a lane inside the decode
    # step, this many context tokens a tick (paged, full attention, a
    # positive multiple of page_size up to max_seq). None = splice admission.
    prefill_chunk: int | None = None
    # Split the expert groups into this many chunks for the grouped FFN.
    ep_chunks: int = 1

    def __post_init__(self):
        validate_prefill_chunk(
            self.prefill_chunk, self.page_size, self.max_seq, self.paged
        )
        validate_ep_chunks(self.ep_chunks, where="ServeConfig")
        if self.ep_chunks > 1:
            groups = self.slots_per_device * (self.virtual_ep or 1)
            validate_ep_chunks(
                self.ep_chunks, groups,
                where="ServeConfig slots_per_device"
                + (" * virtual_ep" if self.virtual_ep else ""),
            )


def validate_prefill_chunk(chunk: int | None, page_size: int, max_seq: int,
                           paged: bool) -> None:
    """Up-front validation for ``ServeConfig(prefill_chunk=...)``."""
    if chunk is None:
        return
    chunk = int(chunk)
    if chunk <= 0:
        raise ValueError(
            f"ServeConfig: prefill_chunk={chunk} must be a positive number "
            f"of tokens (use prefill_chunk=None for splice admission)"
        )
    if chunk % page_size:
        raise ValueError(
            f"ServeConfig: prefill_chunk={chunk} is not page-size-aligned "
            f"(page_size={page_size})"
        )
    if chunk > max_seq:
        raise ValueError(
            f"ServeConfig: prefill_chunk={chunk} exceeds max_seq={max_seq}"
        )
    if not paged:
        raise ValueError("ServeConfig: prefill_chunk requires paged=True")


# A revived device's HBM is blank (no on-wafer disk): its free slot rows are
# scrubbed with this loud finite sentinel until migration slices overwrite
# them. Finite so inert paths stay exactly zero (an empty expert bucket
# computes FFN(0 @ W) = 0 whatever W), loud so any route to an uncommitted
# replica gives non-finite logits instead of decoding stale weights. In
# bf16 it rounds to a finite value too.
BLANK_WEIGHT = 1e30


class SlotReleaseError(RuntimeError):
    """``Server.release`` of a slot that holds no pages (double release, or
    a slot that was never admitted)."""


class PagePool:
    """Host-side physical-page allocator for the paged KV cache. Pages are
    int ids into the pool's leading dim; exhaustion raises (admission
    control belongs to the caller)."""

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self._free = list(range(n_pages - 1, -1, -1))
        self._live: set[int] = set()

    @property
    def n_free(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise RuntimeError(
                f"page pool exhausted: want {n}, have {len(self._free)} "
                f"of {self.n_pages}"
            )
        pages = [self._free.pop() for _ in range(n)]
        self._live.update(pages)
        return pages

    def free(self, pages) -> None:
        for p in pages:
            if p not in self._live:
                raise ValueError(f"double free of page {p}")
            self._live.discard(p)
            self._free.append(p)


class Server:
    def __init__(
        self,
        cfg: ModelConfig,
        ctx: ParallelCtx,
        params: dict,
        serve_cfg: ServeConfig = ServeConfig(),
        distance=None,
        device="cuda",
        table: PlacementTable | None = None,
    ):
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(
                f"params lie on {params['embed'].device}, server device is "
                f"{self.device}"
            )
        self.mesh = ctx.mesh
        if self.mesh is not None:
            self._check_mesh(cfg, ctx, serve_cfg)
        self.cfg = cfg
        if serve_cfg.ep_chunks != ctx.ep_chunks:
            ctx = dataclasses.replace(ctx, ep_chunks=serve_cfg.ep_chunks)
        self.ctx = ctx
        self.scfg = serve_cfg
        self.params = params
        # the EP axis: the mesh's model axis; virtual EP on one rank
        self.ep = ctx.n_model
        if self.ep == 1 and serve_cfg.virtual_ep:
            self.ep = serve_cfg.virtual_ep
        # ESP under a mesh serves every expert's hidden-dim shard: no slot
        # rows to balance (the reference expands slots beside it, which ESP
        # never reads)
        esp_mesh = self.mesh is not None and ctx.moe_impl == "esp"
        self.use_balancer = cfg.is_moe and self.ep > 1 and not esp_mesh
        self.distance = distance or (lambda a, b: abs(a - b))
        self.t = 0
        self.last_mig = -(10**9)
        self.migrations = 0

        if self.use_balancer:
            if ctx.moe_impl == "auto":
                self.ctx = ctx = dataclasses.replace(ctx, moe_impl="ep")
            if ctx.moe_impl != "ep":
                raise ValueError(
                    f"virtual_ep={self.ep} serves replica slots through "
                    f"moe_impl='ep', not {ctx.moe_impl!r} (ESP serves the "
                    f"experts' own weights: leave virtual_ep unset)"
                )
            spd = serve_cfg.slots_per_device
            n_slots = self.ep * spd
            if n_slots < cfg.n_experts:
                raise ValueError("not enough slots for native experts")
            # Expand expert rows to physical slots, one weight tensor at a
            # time: each source tensor is dropped as soon as its slot copy
            # exists, so at most one expanded tensor coexists with the
            # unexpanded ones. A rank keeps only its own slot rows. Fresh
            # start: slot s holds expert s % E. Snapshot restore: the saved
            # table names the owner of every committed slot (free slots
            # fall back to s % E and are never routed to).
            if table is not None:
                if (table.n_experts, table.n_slots, table.slots_per_device) != (
                        cfg.n_experts, n_slots, spd):
                    raise ValueError(
                        f"restored table shape ({table.n_experts} experts, "
                        f"{table.n_slots} slots, {table.slots_per_device} per "
                        f"device) does not match serve config "
                        f"({cfg.n_experts}, {n_slots}, {spd})"
                    )
                owner = table.owner_of_slots()
                rows = np.where(owner >= 0, owner, np.arange(n_slots) % cfg.n_experts)
            else:
                rows = np.arange(n_slots) % cfg.n_experts
            mine = sharding.slot_rows(n_slots, ctx.n_model, ctx.model_rank)
            rows = rows[mine]
            moe = self.params["layers"]["moe"]
            for w in MOE_WEIGHTS:
                src = moe.pop(w)
                dst = src.new_empty((src.shape[0], len(rows), *src.shape[2:]))
                for layer in range(src.shape[0]):
                    for s, e in enumerate(rows):
                        dst[layer, s].copy_(src[layer, int(e)])
                moe[w] = dst
                del src
            self.table = table or PlacementTable.uniform(cfg.n_experts, n_slots, spd)
            self.state = BalancerState(
                n_experts=cfg.n_experts,
                n_devices=self.ep,
                slots_per_device=spd,
                table=self.table,
                load_ema=np.ones(cfg.n_experts) / cfg.n_experts,
                ema_decay=serve_cfg.ema,
            )
            self.driver = (
                MigrationDriver(self.table, min_slices=serve_cfg.migration_slices,
                                mesh=self.mesh)
                if serve_cfg.migration_slices > 0
                else None
            )
        else:
            self.table = None
            self.state = None
            self.driver = None
            if esp_mesh and cfg.is_moe:
                self._shard_expert_hidden()

        self._set_batch(serve_cfg.batch)
        if serve_cfg.paged:
            self.page_size, self.n_blocks = A.paged_layout(
                cfg, serve_cfg.max_seq, serve_cfg.page_size
            )
            backed = serve_cfg.batch * self.n_blocks
            self.n_pool_pages = serve_cfg.pool_pages or backed
            self.page_pool = PagePool(self.n_pool_pages)
            self.trash_page = self.n_pool_pages  # write-off page index
            self._tables = np.full(
                (serve_cfg.batch, self.n_blocks), self.trash_page, np.int32
            )
            self._pages: dict[int, list[int]] = {}
            self._released: set[int] = set()
            self._tables_dirty = False
            # Chunked-prefill ledger: the pages and table row of the (at
            # most one) request mid-prefill, kept out of _pages/_tables
            # until its last chunk lands, so the decode lane treats the
            # slot as empty (trash row, length 0) while the chunk lane
            # writes its KV through the side row.
            self._prefill_pages: dict[int, list[int]] = {}
            self._prefill_row: dict[int, np.ndarray] = {}
            self.last_chunk_logits: torch.Tensor | None = None
            if serve_cfg.prefill_chunk:
                if cfg.sliding_window:
                    raise ValueError(
                        f"prefill_chunk requires full attention: sliding_window="
                        f"{cfg.sliding_window} breaks the chunk lane's "
                        f"slot-j-holds-position-j invariant (the ring remaps "
                        f"logical slots as context wraps)"
                    )
                if serve_cfg.prefill_chunk % self.page_size:
                    raise ValueError(
                        f"prefill_chunk={serve_cfg.prefill_chunk} is not a "
                        f"multiple of the effective page size {self.page_size} "
                        f"(paged_layout shrank it from {serve_cfg.page_size})"
                    )
        # host mirror of per-request written counts (paged): the
        # block-boundary check must not force a device sync per token.
        self._written: np.ndarray | None = None
        # host mirror of cache["pos"]: the overflow guard reads no device.
        self._pos: int | None = None
        self._mask_key = None
        self._mask: torch.Tensor | None = None

    # -- helpers -------------------------------------------------------------

    @staticmethod
    def _check_mesh(cfg: ModelConfig, ctx: ParallelCtx, scfg: ServeConfig) -> None:
        """What serving under a mesh needs: the ``attn`` pattern (the others'
        layouts are still to port) and an initialised process group."""
        T.check_mesh(cfg, ctx)
        if not dist.is_initialized():
            raise RuntimeError(
                "Server under a mesh needs an initialised torch.distributed "
                "process group (parallel.mesh.init_distributed); it does not "
                "serve single-process instead"
            )

    def _shard_expert_hidden(self) -> None:
        """Keep the rank's hidden-dim shard of every expert weight (ESP
        under a mesh), one weight at a time."""
        fs = sharding.expert_hidden(self.cfg.moe_d_ff_, self.ctx.n_model,
                                    self.ctx.model_rank)
        moe = self._moe()
        for w in MOE_WEIGHTS:
            src = moe.pop(w)
            moe[w] = (src[..., fs] if w != "w_down" else src[:, :, fs]).contiguous()
            del src

    def _set_batch(self, batch: int) -> None:
        """This rank's requests of a ``batch``: every row with no mesh or a
        batch that does not divide the data axis (replicated), which EP
        refuses (the reference's ``validate_ep_token_split``)."""
        ctx = self.ctx
        self._rows = sharding.batch_rows(batch, ctx.n_batch, ctx.batch_rank)
        self._split = self._rows.stop - self._rows.start < batch
        if (self.mesh is not None and ctx.moe_impl == "ep" and self.cfg.is_moe
                and batch % ctx.n_batch):
            raise ValueError(
                f"EP under a {ctx.n_batch}-way data axis splits the batch: "
                f"batch={batch} does not divide it"
            )

    def _local(self, slot: int) -> int | None:
        """Row of global batch slot ``slot`` on this rank, None if another
        data rank serves it."""
        if not self._rows.start <= slot < self._rows.stop:
            return None
        return slot - self._rows.start

    def _gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The global batch from every data rank's rows (dim 0)."""
        if not self._split:
            return t
        return all_gather_dim(t, 0, self.mesh.data_group, self.mesh.batch_order)

    def _moe(self) -> dict:
        return self.params["layers"]["moe"]

    def _require_paged(self, what: str) -> None:
        if not self.scfg.paged:
            raise ValueError(f"{what} requires ServeConfig(paged=True)")

    def _prefill(self, tokens, tables=None, lengths=None, replicated=False, embeds=None):
        # Every prefill routes by the committed table, as decode and the
        # reference's chunk lane do (JAX decode_step passes placement to the
        # chunk's moe_apply). The reference's splice prefill routes each copy
        # to its expert's native slot instead, so the port's outputs leave
        # the reference's in two places: after a revival, by design (a
        # native slot may then hold another expert or BLANK_WEIGHT), and
        # wherever a native bucket overflows once a hot expert has committed
        # replicas: the reference drops the copies its native bucket cannot
        # take, the port spreads them over the replicas and keeps more. There
        # the port agrees with the reference's own chunked admission.
        # A batch-1 admission prefill runs on every rank (``replicated``).
        placement = self.table.device_view(self.device) if self.use_balancer else None
        ctx = self.ctx
        if replicated and self.mesh is not None:
            ctx = dataclasses.replace(ctx, batch_replicated=True)
        if not self.scfg.paged:
            return T.prefill(self.params, tokens, self.cfg, ctx,
                             max_seq=self.scfg.max_seq, placement=placement,
                             embeds=embeds)
        return T.prefill(
            self.params, tokens, self.cfg, ctx,
            max_seq=self.scfg.max_seq, paged=True,
            page_size=self.scfg.page_size, n_pages=self.n_pool_pages,
            tables=torch.as_tensor(tables, device=self.device),
            lengths=torch.as_tensor(lengths, dtype=torch.int32, device=self.device),
            placement=placement, embeds=embeds,
        )

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    def _prompt_rows(self, tokens, embeds) -> int:
        """KV rows a prefill writes per request: prompt tokens plus any
        prepended frontend-stub embeddings (see ``T.prefill``)."""
        s = tokens.shape[1]
        if (embeds is not None and self.cfg.frontend_stub
                and self.cfg.block_pattern != "encdec"):
            s += embeds.shape[1]
        return s

    # -- request lifecycle ---------------------------------------------------

    def prefill(self, tokens, embeds=None, lengths=None):
        """Prime a cache for a batch of prompts; returns the logits of every
        request (under a mesh too) and this rank's cache. ``embeds`` (B, F,
        d) are the frontend stub's: prepended (vlm) or encoded (enc-dec),
        in the dtype given (see ``T.prefill``). Paged: allocate each
        request's blocks from the shared pool (``lengths`` marks true prompt
        lengths of right-padded ragged batches; prepended embeds count
        toward every request); pages of a previously prefilled batch are
        released first."""
        tokens = self._tokens(tokens)
        b = tokens.shape[0]
        s = self._prompt_rows(tokens, embeds)
        self._set_batch(b)
        rows = self._rows
        if embeds is not None:
            embeds = torch.as_tensor(embeds, device=self.device)[rows]
        if not self.scfg.paged:
            logits, cache = self._prefill(tokens[rows], embeds=embeds)
            self._pos = s
            return self._gather_rows(logits), cache
        n_embed = s - tokens.shape[1]
        lens = (
            np.full(b, s, np.int32) if lengths is None
            else np.asarray(lengths, np.int32) + n_embed
        )
        for slot in list(self._pages):
            self.release(slot)
        for slot in list(self._prefill_pages):
            self.abort_chunk_prefill(slot)
        self._released = set()
        self._tables = np.full((b, self.n_blocks), self.trash_page, np.int32)
        self._tables_dirty = False
        cap = self.n_blocks * self.page_size
        for slot in range(b):
            need = min(-(-int(min(lens[slot], cap)) // self.page_size), self.n_blocks)
            pages = self.page_pool.alloc(need)
            self._pages[slot] = pages
            self._tables[slot, :need] = pages
        logits, cache = self._prefill(tokens[rows], self._tables[rows], lens[rows],
                                      embeds=embeds)
        self._written = lens.copy()
        self._pos = s
        return self._gather_rows(logits), cache

    def release(self, slot: int, cache: dict | None = None):
        """Free request ``slot``'s pages back to the pool. With ``cache``,
        also clear its table row and length now; without it, the device
        tables are refreshed on the next ``decode`` before any write.
        Raises :class:`SlotReleaseError` if the slot holds no pages."""
        self._require_paged("release")
        if slot not in self._pages:
            raise SlotReleaseError(
                f"release of slot {slot}, which holds no pages (already "
                f"released, or never admitted)"
            )
        self.page_pool.free(self._pages.pop(slot))
        self._released.add(slot)
        self._tables[slot, :] = self.trash_page
        if self._written is not None:
            self._written[slot] = 0
        if cache is None:
            self._tables_dirty = True
            return None
        self._set_row(cache, slot, 0)
        return cache

    def _stacked_tables(self, n_layers: int) -> torch.Tensor:
        """This rank's rows of the block tables, one copy a layer."""
        t = torch.as_tensor(self._tables[self._rows], device=self.device)
        return t[None].expand(n_layers, *t.shape)

    def _set_row(self, cache: dict, slot: int, length: int) -> None:
        """Refresh the device tables and set ``slot``'s length (on the rank
        that serves it)."""
        layers = cache["layers"]
        layers["tables"].copy_(self._stacked_tables(layers["tables"].shape[0]))
        row = self._local(slot)
        if row is not None:
            layers["lengths"][:, row] = length

    def empty_cache(self) -> dict:
        """A paged cache with every batch slot empty (the starting state for
        ``prefill_into_slot``); previously admitted pages go back to the
        pool."""
        self._require_paged("empty_cache")
        b = self.scfg.batch
        for slot in list(self._pages):
            self.release(slot)
        for slot in list(self._prefill_pages):
            self.abort_chunk_prefill(slot)
        self._set_batch(b)
        self._released = set(range(b))
        self._tables = np.full((b, self.n_blocks), self.trash_page, np.int32)
        self._tables_dirty = False
        self._written = np.zeros(b, np.int32)
        self._pos = 0
        return T.init_cache(
            self.cfg, self._rows.stop - self._rows.start, self.scfg.max_seq,
            dtype=self.params["embed"].dtype, paged=True,
            page_size=self.scfg.page_size, n_pages=self.n_pool_pages,
            device=self.device, ctx=self.ctx,
        )

    def prefill_into_slot(self, slot: int, tokens, cache: dict, length=None):
        """Admit one request into batch row ``slot`` of a live cache: run a
        batch-1 prefill whose table indexes the same pool id space, then
        splice its pool pages, table row and length into ``cache`` (other
        rows untouched). Returns ``(logits (1, 1, V), cache)``. Under a
        mesh every rank runs the prefill and splices the pages; the rank
        that serves ``slot`` sets its length."""
        self._require_paged("prefill_into_slot")
        if slot in self._pages:
            raise RuntimeError(f"slot {slot} is still admitted; release it before reuse")
        if self._written is None:
            self._written = np.zeros(self.scfg.batch, np.int32)
        tokens = self._tokens(tokens).reshape(1, -1)
        true_len = int(length if length is not None else tokens.shape[1])
        cap = self.n_blocks * self.page_size
        need = min(-(-min(true_len, cap) // self.page_size), self.n_blocks)
        pages = self.page_pool.alloc(need)
        row = np.full((1, self.n_blocks), self.trash_page, np.int32)
        row[0, :need] = pages
        logits, small = self._prefill(tokens, row, np.asarray([true_len], np.int32),
                                      replicated=True)
        self._pages[slot] = pages
        self._tables[slot] = row[0]
        self._released.discard(slot)
        self._written[slot] = true_len
        self._tables_dirty = False
        layers = cache["layers"]
        if need:
            idx = torch.as_tensor(pages, dtype=torch.long, device=self.device)
            for name in ("pool_k", "pool_v"):
                layers[name][:, idx] = small["layers"][name][:, idx]
        self._set_row(cache, slot, true_len)
        return logits, cache

    # -- chunked prefill (the admission lane inside the decode step) ---------

    def begin_chunk_prefill(self, slot: int, length: int) -> None:
        """Start a chunked admission into batch row ``slot``: allocate every
        page ``length`` context rows need, into the side ledger. The live
        cache is untouched: the slot's device table row stays at the
        write-off page and its length at 0 for the whole prefill, so the
        decode lane's masked write for the row keeps landing on the trash
        page."""
        if not self.scfg.prefill_chunk:
            raise ValueError("begin_chunk_prefill requires ServeConfig(prefill_chunk=N)")
        if slot in self._pages or slot in self._prefill_pages:
            raise RuntimeError(
                f"slot {slot} is still admitted or mid-prefill; release or "
                f"abort it before reuse"
            )
        cap = self.n_blocks * self.page_size
        need = min(-(-min(int(length), cap) // self.page_size), self.n_blocks)
        pages = self.page_pool.alloc(need)
        row = np.full(self.n_blocks, self.trash_page, np.int32)
        row[:need] = pages
        self._prefill_pages[slot] = pages
        self._prefill_row[slot] = row

    def chunk_operand(self, slot: int, tokens, start: int, length: int) -> dict:
        """The decode step's prefill-lane operand for one chunk of the
        request mid-prefill in ``slot``: ``tokens`` is the ``(prefill_chunk,)``
        buffer right-padded past ``length``, ``start`` the absolute position
        of ``tokens[0]``."""
        if slot not in self._prefill_row:
            raise RuntimeError(
                f"slot {slot} has no chunked prefill in flight "
                f"(begin_chunk_prefill first)"
            )
        tokens = np.asarray(tokens, np.int64).reshape(1, -1)
        if tokens.shape[1] != self.scfg.prefill_chunk:
            raise ValueError(
                f"chunk_operand: got {tokens.shape[1]} tokens, want exactly "
                f"prefill_chunk={self.scfg.prefill_chunk} (right-pad past "
                f"`length`)"
            )
        return {
            "tokens": torch.as_tensor(tokens, device=self.device),
            "table": torch.as_tensor(self._prefill_row[slot], device=self.device),
            "start": int(start),
            "length": int(length),
        }

    def noop_chunk(self) -> dict:
        """The idle prefill-lane operand (length 0, all-trash table), as the
        reference builds it; ``decode_step`` skips such a chunk."""
        return {
            "tokens": torch.zeros((1, self.scfg.prefill_chunk), dtype=torch.long,
                                  device=self.device),
            "table": torch.full((self.n_blocks,), self.trash_page, dtype=torch.int32,
                                device=self.device),
            "start": 0,
            "length": 0,
        }

    def finish_chunk_prefill(self, slot: int, cache: dict, length: int) -> dict:
        """The last chunk landed: flip ``slot`` live. The chunk lane already
        wrote every KV row into the pool through the side row, so this moves
        the pages into the live ledger and splices the table row and the
        true length into the device cache (in place)."""
        if slot not in self._prefill_pages:
            raise RuntimeError(f"slot {slot} has no chunked prefill in flight")
        if self._written is None:
            self._written = np.zeros(self.scfg.batch, np.int32)
        self._pages[slot] = self._prefill_pages.pop(slot)
        self._tables[slot] = self._prefill_row.pop(slot)
        self._released.discard(slot)
        self._written[slot] = int(length)
        self._tables_dirty = False
        self._set_row(cache, slot, int(length))
        return cache

    def abort_chunk_prefill(self, slot: int) -> None:
        """Tear down a mid-prefill admission (preemption, crash recovery):
        the side pages go back to the pool. Nothing was spliced into the
        live cache, so no device state is undone."""
        if slot not in self._prefill_pages:
            raise SlotReleaseError(
                f"abort_chunk_prefill of slot {slot}, which has no chunked "
                f"prefill in flight"
            )
        self.page_pool.free(self._prefill_pages.pop(slot))
        del self._prefill_row[slot]

    def next_write_unbacked(self, slot: int) -> bool:
        """Would this request's next decode write need a fresh pool page?"""
        cap = self.n_blocks * self.page_size
        written = int(self._written[slot])
        nxt = written % cap if self.cfg.sliding_window else min(written, cap - 1)
        return bool(self._tables[slot, nxt // self.page_size] == self.trash_page)

    def _ensure_pages(self, cache: dict) -> dict:
        """Allocate the page a request's next write lands on, if its block
        table doesn't back it yet (host-side check and alloc)."""
        layers = cache["layers"]
        if self._written is None:
            self._written = layers["lengths"][0].cpu().numpy().copy()
        cap = self.n_blocks * self.page_size
        w = self.cfg.sliding_window or 0
        changed = self._tables_dirty
        self._tables_dirty = False
        for slot in self._pages:
            if self.next_write_unbacked(slot):
                written = int(self._written[slot])
                nxt = written % cap if w else min(written, cap - 1)
                (page,) = self.page_pool.alloc(1)
                self._pages[slot].append(page)
                self._tables[slot, nxt // self.page_size] = page
                changed = True
        if changed:
            layers["tables"].copy_(self._stacked_tables(layers["tables"].shape[0]))
        return cache

    def _slot_mask(self, batch: int) -> torch.Tensor:
        """This rank's live batch rows as a bool tensor on the device,
        rebuilt (one host-to-device copy) only when the released set
        changes."""
        key = (batch, frozenset(self._released))
        if self._mask_key != key:
            live = np.ones(batch, bool)
            live[sorted(self._released)] = False
            self._mask = torch.as_tensor(live[self._rows], device=self.device)
            self._mask_key = key
        return self._mask

    def decode(self, token, cache: dict, chunk: dict | None = None):
        """One step: every live request consumes one token (``token`` is
        ``(B, 1)``, every request's under a mesh too), and with
        ``ServeConfig(prefill_chunk=N)`` the chunk operand ``chunk`` (see
        ``chunk_operand``; None = no admission in flight) rides the same
        step. ``cache`` is updated in place and returned with every
        request's logits; the chunk's logits land on
        ``last_chunk_logits``."""
        if chunk is not None and not self.scfg.prefill_chunk:
            raise ValueError("decode(chunk=...) requires ServeConfig(prefill_chunk=N)")
        if self._pos is None:
            self._pos = int(cache["pos"])
        pos = self._pos
        windowed = bool(self.cfg.sliding_window)
        if self.scfg.paged:
            cache = self._ensure_pages(cache)
            if not windowed:
                cap = self.n_blocks * self.page_size
                live = self._pages or range(len(self._written))
                full = [s for s in live if self._written[s] >= cap]
                if full:
                    raise RuntimeError(
                        f"decode past capacity={cap} for request(s) {full} "
                        f"(cache full): release them or raise max_seq"
                    )
        elif not windowed and pos >= self.scfg.max_seq:
            # the dense cache freezes at capacity; serving refuses the step
            raise RuntimeError(
                f"decode past max_seq={self.scfg.max_seq} (cache full, "
                f"pos={pos}): release the request or raise max_seq"
            )
        if self.use_balancer:
            # Step boundary: commit migrations whose last slice landed, then
            # queue this tick's weight slices ahead of the step's kernels.
            self.drain_migrations()
        placement = self.table.device_view(self.device) if self.use_balancer else None
        # paged serving masks released rows out of MoE routing; a dense
        # batch is all live
        slot_mask = self._slot_mask(token.shape[0]) if self.scfg.paged else None
        logits, cache, stats = T.decode_step(
            self.params, self._tokens(token)[self._rows], cache, self.cfg, self.ctx,
            placement=placement, slot_mask=slot_mask, chunk=chunk,
        )
        logits = self._gather_rows(logits)
        self.last_chunk_logits = stats.get("chunk_logits")
        if self.scfg.paged and self._written is not None:
            for slot in range(len(self._written)):
                if slot not in self._released:
                    self._written[slot] += 1
            rel = [r for r in map(self._local, sorted(self._released)) if r is not None]
            if rel:
                # keep released rows inert: pin their length back to 0.
                idx = torch.as_tensor(rel, device=self.device)
                cache["layers"]["lengths"][:, idx] = 0
        self._pos = pos + 1
        self.t += 1
        if self.use_balancer:
            counts = stats["expert_counts"]
            if self.mesh is not None:
                # every rank observes the global batch's counts, so every
                # rank plans the same migrations
                dist.all_reduce(counts, group=self.mesh.data_group)
            counts = counts.cpu().numpy()
            self.state.observe(counts)
            self._maybe_balance(counts)
        return logits, cache

    def generate(self, prompt, n_tokens: int, embeds=None) -> torch.Tensor:
        """Greedy decode: ``(B, n_tokens)`` int64 tokens on the device, every
        request's on every rank under a mesh; ``embeds`` as in ``prefill``."""
        logits, cache = self.prefill(prompt, embeds=embeds)
        out = []
        tok = torch.argmax(logits[:, -1:], dim=-1)
        for _ in range(n_tokens):
            out.append(tok)
            logits, cache = self.decode(tok, cache)
            tok = torch.argmax(logits[:, -1:], dim=-1)
        return torch.cat(out, dim=1)

    # -- balancing -----------------------------------------------------------

    def _maybe_balance(self, counts):
        if not should_trigger(
            [counts], self.scfg.alpha, self.t - self.last_mig, self.scfg.beta
        ):
            return
        plan = topology_aware_balance(self.state, self.distance)
        if not plan:
            return
        self.last_mig = self.t
        self.apply_plan(plan)

    def apply_plan(self, plan) -> int:
        """Execute a balancer plan ``[(expert, src, dst), ...]``. With a
        driver: reserve destination slots now, copy slices one per decode
        tick, count commits in ``self.migrations``; returns the number
        accepted. Without: synchronous whole-expert copies, counted now."""
        if not plan:
            return 0
        if self.driver is None:
            applied = sum(self._apply_migration(mig) for mig in plan)
            self.migrations += applied
            return applied
        return len(self.driver.submit(plan, self._moe(), self.t))

    def drain_migrations(self) -> int:
        """Advance in-flight stepped migrations by one tick; returns the
        number committed this tick."""
        if self.driver is None:
            return 0
        committed = self.driver.tick(self._moe(), self.t)
        self.migrations += len(committed)
        return len(committed)

    def _copy_expert_rows(self, src_slot: int, dst_slot: int) -> None:
        """Whole-expert row copy (the instantaneous path), in place."""
        moe = self._moe()
        for w in MOE_WEIGHTS:
            copy_row_slice(moe[w], src_slot, dst_slot, 0, moe[w].shape[2], self.mesh)

    def _apply_migration(self, mig) -> bool:
        """Replicate expert ``e`` onto a free slot of device ``dst`` now.
        Returns True iff applied; a no-op leaves the table untouched."""
        e, _src, dst = mig
        slot = self.table.try_reserve(e, dst)
        if slot is None:
            return False
        self._copy_expert_rows(int(self.table.slot_of[e, 0]), slot)
        self.table.commit(e, slot)
        return True

    # -- fault tolerance ------------------------------------------------------

    def _ep_device(self, what: str, device) -> int:
        device = int(device)
        if not 0 <= device < self.ep:
            raise ValueError(
                f"{what}: device {device} is outside the EP axis "
                f"(want 0 <= device < {self.ep})"
            )
        return device

    def _retarget(self, dead: int, mig):
        """Replacement for a migration aborted by ``dead``'s death: same
        expert, sourced from a live committed replica, aimed at the nearest
        live device with a free slot that neither hosts nor expects it.
        None when no such device exists."""
        e, _src, _dst = mig
        src = next(
            (
                d
                for d in self.table.replica_devices(e, include_pending=False)
                if d != dead and d not in self.state.dead
            ),
            None,
        )
        if src is None:
            return None            # evacuation will recreate the expert
        cand = [
            d
            for d in range(self.ep)
            if d != dead
            and d not in self.state.dead
            and d not in self.table.replica_devices(e)
            and self.table.free_slot(d) is not None
        ]
        if not cand:
            return None
        return (e, src, min(cand, key=lambda d: self.distance(src, d)))

    def mark_dead(self, device: int) -> list:
        """Node failure, the full evacuation path:

        1. in-flight stepped migrations touching the device are resolved
           first (to it: abort and requeue toward a live destination; from
           it: fast-forward), so no torn replica is ever committed;
        2. ``evacuate`` pins the device's heat to infinity and commits a
           replica for every expert whose only live copy sat there;
        3. each evacuation entry's weight rows are copied whole, read from
           the dead device's slot: in this logical death model routing
           stops but the memory stays addressable (a real die failure
           would restore the rows from checkpoint shards instead);
        4. the device's replicas drop out of the routing view.

        Under a mesh the dead device's rank still runs, and its rows move
        to their new ranks as migration slices do.
        Returns the evacuation plan ``[(expert, src, dst), ...]``."""
        if self.state is None:
            return []
        if self.driver is not None:
            self.driver.handle_device_death(
                device, self._moe(), self.t,
                retarget=lambda mig: self._retarget(device, mig),
            )
        plan = evacuate(self.state, device, self.distance)
        for e, _src, dst in plan:
            # The orphan's copy: usually on the dying device; after repeated
            # failures it may sit on an earlier-dead one (column 0).
            src_slot = self.table.slot_on_device(e, device)
            if src_slot is None:
                src_slot = int(self.table.slot_of[e, 0])
            self._copy_expert_rows(src_slot, self.table.slot_on_device(e, dst))
        self.table.drop_device(device)
        return plan

    def revive(self, device: int) -> list:
        """Re-admit a repaired device with blank HBM:

        1. the balancer forgets the death (finite heat, straggler penalty
           reset);
        2. the device's free slot rows are scrubbed with ``BLANK_WEIGHT``,
           in place; slots still committed there (sole-copy orphans of a
           failed evacuation) are spared;
        3. ``revival_plan`` seeds the blank slots with the hottest
           per-replica experts from their nearest live hosts, through
           ``apply_plan`` (the stepped driver when configured), so routing
           references the device only once each copy commits.

        Under a mesh only the rank that holds the device's slot rows
        (``sharding.slot_rows``) scrubs them. Returns the revival plan."""
        if self.state is None:
            raise ValueError("revive requires the balancer serving path")
        device = self._ep_device("revive", device)
        if device not in self.state.dead:
            raise ValueError(f"revive: device {device} is not dead")
        self.state.revive(device)
        spd = self.table.slots_per_device
        used = self.table.used_slots()
        mine = sharding.slot_rows(self.table.n_slots, self.ctx.n_model,
                                  self.ctx.model_rank)
        blank = [s - mine.start for s in range(device * spd, (device + 1) * spd)
                 if not used[s] and mine.start <= s < mine.stop]
        if blank:
            idx = torch.as_tensor(blank, dtype=torch.long, device=self.device)
            moe = self._moe()
            for w in MOE_WEIGHTS:
                moe[w][:, idx] = BLANK_WEIGHT
        plan = revival_plan(self.state, device, self.distance)
        self.apply_plan(plan)
        return plan

    # -- crash-safe snapshot/restore ------------------------------------------

    @classmethod
    def restore_snapshot(cls, snap, cfg: ModelConfig, ctx: ParallelCtx, params,
                         distance=None, device="cuda"):
        """Rebuild a live ``Server`` on a fresh process from a
        :class:`~repro_torch.runtime.snapshot.ServerSnapshot` and the
        logical params (un-expanded expert rows, as ``__init__`` takes them;
        the snapshot holds no weights). Expert rows are placed by the saved
        committed table; the balancer's load EMA, dead set and slowdowns and
        the counters are restored; pending migrations are re-submitted from
        slice zero (their partial slices died with the crashed process, and
        nothing routes to a reservation before it commits). Not under a mesh
        yet (ROADMAP Queue 1 item 5)."""
        if ctx.mesh is not None:
            raise NotImplementedError(
                "restoring a snapshot under a mesh is not ported yet "
                "(ROADMAP Queue 1 item 5)"
            )
        scfg = ServeConfig(**snap.serve_cfg)
        table = None
        if snap.table is not None:
            table = PlacementTable(
                n_experts=cfg.n_experts,
                n_slots=int(snap.table["n_slots"]),
                slots_per_device=int(snap.table["slots_per_device"]),
                slot_of=snap.table["slot_of"],
                n_replicas=snap.table["n_replicas"],
            )
        srv = cls(cfg, ctx, params, scfg, distance=distance, device=device, table=table)
        srv.t = int(snap.t)
        srv.last_mig = int(snap.last_mig)
        srv.migrations = int(snap.migrations)
        if srv.state is not None:
            srv.state.load_ema = np.asarray(snap.load_ema, float).copy()
            srv.state.dead = {int(d) for d in snap.dead}
            srv.state.slowdown = (
                None if snap.slowdown is None else np.asarray(snap.slowdown, float).copy()
            )
            if srv.driver is not None and snap.pending_migrations:
                srv.driver.submit([tuple(m["mig"]) for m in snap.pending_migrations],
                                  srv._moe(), srv.t)
        return srv

    def report_step_time(self, device: int, ratio: float) -> None:
        """Straggler mitigation: fold a measured step-time ratio (measured /
        median) into the device's heat multiplier."""
        if self.state is None:
            return
        device = self._ep_device("report_step_time", device)
        ratio = float(ratio)
        if not np.isfinite(ratio) or ratio <= 0:
            raise ValueError(
                f"report_step_time: ratio {ratio} must be a finite positive "
                f"step-time ratio (measured / median)"
            )
        if self.state.slowdown is None:
            self.state.slowdown = np.ones(self.ep)
        self.state.slowdown[device] = 0.8 * self.state.slowdown[device] + 0.2 * ratio
