"""Continuous-batching serving engine over the paged KV cache.

Counterpart of ``vats_tpu/inference/serving.py``, with every mode of the
JAX engine:

  * :class:`PageAllocator`: a free list over the physical page pool; page 0
    is the scratch page inactive rows point at.
  * :class:`PrefixCache`: full prompt pages content-addressed by a chained
    hash of their tokens, refcounted while mapped, parked in an LRU when
    idle and reclaimed only under memory pressure.
  * :class:`ServingEngine`: admission bucketed by prompt size, batched tail
    prefills padded to power-of-two groups with scratch rows on page 0
    (at most ``max_prefill_tokens`` padded tokens a forward, when set),
    head-of-line waiting for pages, preemption of the youngest row,
    ``decode_block_steps``, prompt-lookup speculative decoding
    (``spec_k``, greedy acceptance), per-request sampling and
    ``overlap_scheduling``.

What replaces the JAX machinery:
  * the pool (and the int8 scales pool) is one set of tensors updated in
    place by every forward (K1/K4 commit in the kernel, prefills append):
    no donated buffers.  An MLA model (``LatentModelArgs``) gets a latent
    pool (``ops/mla_decode.LatentPagedCache``: one vector a token a layer)
    under the same allocator, preemption and prefix cache; without a
    prefix cache its prefills attend their own window and read no page;
  * every program the JAX engine jits runs from the engine's
    :class:`~vats_tpu_torch.inference.graphs.GraphSet` on the card: one
    CUDA graph per tail prefill shape (bucket, padded group size), per
    decode block length (``decode_block_steps``, and 1 for the thin-margin
    fallback) and one for the speculative verify forward ([B, spec_k + 1]).
    Each key's first call runs eagerly as a warm-up, and replays follow.
    Each reads static device buffers that the host state is copied into
    (ids, masks, tables, lengths, input tokens, drafts, the per-row
    sampling values) and writes a static output: a prefill's first tokens,
    a decode block's [B, k] tokens (k forwards with the tokens kept on the
    device, in place of the JAX ``fori_loop``), the verify forward's
    [B, spec_k + 1] greedy tokens.  The host syncs once per forward or
    block, when it reads those tokens (copied to pinned memory behind a
    CUDA event).  On the CPU the same bodies run eagerly;
  * overlap mode relies on the program order of one CUDA stream where the
    JAX engine relies on dispatch order: a page freed and reallocated on
    the host is written only by work queued later, which runs after every
    queued forward that still reads it.  Host-to-device copies into the
    static buffers go through pinned memory, so queuing a block never
    waits for the one in flight; they are queued behind it, so they never
    change what it reads.

Spans (``utils/profiling.annotate``, on only while a profiler runs) mark
what a step does on the host: ``serve.admit`` (lookups, pages, groups),
inside it ``serve.prefill`` (one grouped prefill, with its request ids) and
``serve.prefill.wait`` (the wait for its first tokens); ``serve.dispatch``
(pages, the copies into the static buffers, the block's launch);
``serve.block_wait`` and ``serve.commit`` (reading a block's tokens, and
committing them to the rows); ``serve.retire``; ``serve.verify`` (a
speculative step).

Counters read on the host, with no device sync: ``forwards``,
``prefill_shapes``, ``preemptions``, the allocator's ``high_water`` and
:meth:`ServingEngine.kv_window_dead_bytes`, the K/V bytes the pool holds
for windowed layers at positions their decode no longer attends.

The engine runs on the device of the model it is given (a ``TextLM`` or a
``QuantizedModel``) and never moves it.  Greedy by default; a request
reproduces the greedy tokens ``generate_paged`` gives it alone, whatever
its batchmates, preemptions or prefix hits.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from vats_tpu_torch.configs.nlp import LatentModelArgs, layer_attention
from vats_tpu_torch.device import resolve_dtype
from vats_tpu_torch.inference.graphs import GraphSet, copy_to_static
from vats_tpu_torch.inference.sampling import sample_logits, sample_logits_per_row
from vats_tpu_torch.ops.decode_attention import PagedKVCache
from vats_tpu_torch.ops.mla_decode import LatentPagedCache
from vats_tpu_torch.utils.profiling import annotate


@dataclasses.dataclass
class SamplingParams:
    """Per-request sampling knobs; needs ``per_request_sampling=True``.

    temperature <= 0 means greedy; top_k == 0 means no explicit top-k (the
    engine still samples within its static ``sampling_kmax`` top logits);
    top_p == 0 disables nucleus filtering.  ``seed`` keys the request's
    draws by (seed, sequence position), so its stream does not depend on
    batch composition or preemption; any int is wrapped to uint32."""

    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 0.0
    seed: Optional[int] = None


@dataclasses.dataclass
class Request:
    rid: int
    prompt_ids: List[int]
    max_new_tokens: int
    output_ids: List[int] = dataclasses.field(default_factory=list)
    # tokens generated before a preemption (the continuation's prompt
    # includes them; the final answer is carried + output_ids)
    carried: List[int] = dataclasses.field(default_factory=list)
    sampling: Optional[SamplingParams] = None
    done: bool = False


class PageAllocator:
    """Free-list allocator over physical page ids [first_page, num_pages).

    Page 0 is reserved by the engine as the scratch page for inactive rows,
    so allocators start at 1 by default."""

    def __init__(self, num_pages: int, first_page: int = 1):
        self._free = list(range(num_pages - 1, first_page - 1, -1))
        self.capacity = num_pages - first_page
        self.high_water = 0

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_used(self) -> int:
        return self.capacity - len(self._free)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise MemoryError(
                f"page pool exhausted: need {n}, free {len(self._free)}"
            )
        pages = [self._free.pop() for _ in range(n)]
        self.high_water = max(self.high_water, self.num_used)
        return pages

    def free(self, pages: List[int]) -> None:
        self._free.extend(pages)


class PrefixCache:
    """Content-addressed cache of immutable full KV pages.

    Page i's key is a CHAINED hash covering tokens [0, (i+1)*page_size), so
    a hit on page i implies the whole prefix matches.  Refcounted while
    mapped by active rows; refcount-0 pages park in an LRU
    (insertion-ordered dict) and return to the allocator only through
    :meth:`reclaim`."""

    def __init__(self):
        self._page_of: Dict[int, int] = {}  # key -> physical page
        self._refs: Dict[int, int] = {}  # key -> active refcount
        self._key_of: Dict[int, int] = {}  # physical page -> key
        self._lru: Dict[int, int] = {}  # key -> page, refcount == 0 only
        self.hit_tokens = 0
        self.query_tokens = 0

    @staticmethod
    def chain_keys(prompt_ids: List[int], page_size: int, n_pages: int):
        keys, h = [], 0
        for i in range(n_pages):
            h = hash((h, tuple(prompt_ids[i * page_size:(i + 1) * page_size])))
            keys.append(h)
        return keys

    def lookup(self, keys: List[int]) -> List[int]:
        """Longest cached prefix: physical pages for leading keys present."""
        pages = []
        for k in keys:
            page = self._page_of.get(k)
            if page is None:
                break
            pages.append(page)
        return pages

    def acquire(self, keys: List[int]) -> None:
        for k in keys:
            self._refs[k] = self._refs.get(k, 0) + 1
            self._lru.pop(k, None)

    def release(self, keys: List[int]) -> None:
        for k in keys:
            n = self._refs.get(k, 0) - 1
            if n > 0:
                self._refs[k] = n
            else:
                self._refs.pop(k, None)
                if k in self._page_of:
                    self._lru[k] = self._page_of[k]

    def insert(self, key: int, page: int) -> bool:
        """Register a page (the caller then holds one ref).  False if the
        key is already mapped: the first writer wins, and the caller keeps
        its private copy and must not count the key among its refs."""
        if key in self._page_of:
            return False
        self._page_of[key] = page
        self._key_of[page] = key
        self._refs[key] = self._refs.get(key, 0) + 1
        return True

    def owns(self, page: int) -> bool:
        return page in self._key_of

    def reclaim(self, n: int) -> List[int]:
        """Evict up to n LRU refcount-0 pages; returns the physical pages."""
        out = []
        for k in list(self._lru):
            if len(out) >= n:
                break
            page = self._lru.pop(k)
            self._page_of.pop(k, None)
            self._refs.pop(k, None)
            self._key_of.pop(page, None)
            out.append(page)
        return out

    @property
    def num_cached(self) -> int:
        return len(self._page_of)


class ServingEngine:
    """Continuous-batching paged-KV serving.

    Usage::

        eng = ServingEngine(model, max_batch=4, max_context=512)
        rid = eng.submit([1, 2, 3], max_new_tokens=32)
        outputs = eng.run()          # {rid: [token, ...]}

    Greedy by default; sampled mode via do_sample/temperature/top_k/top_p
    (draws from a ``torch.Generator`` seeded by ``seed``).  With
    ``per_request_sampling=True`` each submit() may carry its own
    :class:`SamplingParams`; greedy rows stay exact and seeded rows draw a
    (seed, position)-keyed stream.  Requests queue while every row is busy
    or the page pool is full (``total_pages`` may be well below
    max_batch * max_context / page_size).

    ``max_prefill_tokens``: the most padded tokens (group rows padded to a
    power of two, times the bucket) one prefill forward may take; a
    bucket's group is split to fit, down to one row a forward (a bucket
    above the budget still prefills one row).  None: groups of up to
    ``MAX_PREFILL_GROUP`` rows, as in the JAX engine.  Lossless MoE routing
    sizes every expert's buffer to all the tokens of a forward, so this
    bounds a forward's transient memory."""

    #: rows prefilled per forward (batched admission); group sizes are
    #: padded to powers of two, as in the JAX engine
    MAX_PREFILL_GROUP = 16

    def __init__(
        self,
        model,
        *,
        max_batch: int,
        max_context: int,
        page_size: int = 128,
        total_pages: Optional[int] = None,
        kv_quant: Optional[str] = None,
        do_sample: bool = False,
        temperature: float = 1.0,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        approx_top_k: bool = False,
        eos_token_id: Optional[int] = None,
        pad_token_id: int = 0,
        prompt_buckets: Tuple[int, ...] = (32, 128, 512, 2048),
        seed: int = 0,
        prefix_caching: bool = False,
        decode_block_steps: int = 1,
        spec_k: int = 0,
        spec_ngram: int = 3,
        per_request_sampling: bool = False,
        sampling_kmax: int = 64,
        overlap_scheduling: bool = False,
        max_prefill_tokens: Optional[int] = None,
    ):
        if kv_quant not in (None, "int8"):
            raise ValueError(f"unsupported kv_quant mode: {kv_quant!r}")
        if max_prefill_tokens is not None and max_prefill_tokens < 1:
            raise ValueError("max_prefill_tokens must be >= 1 (or None)")
        cfg = model.cfg
        self.model = model
        self.cfg = cfg
        self.device = model.device
        self.max_batch = max_batch
        self.max_context = min(max_context, cfg.max_seq_len)
        self.page_size = page_size
        self.pages_per_row = -(-self.max_context // page_size)
        self.eos_token_id = eos_token_id
        self.pad_token_id = pad_token_id
        self.prompt_buckets = tuple(
            b for b in sorted(prompt_buckets) if b <= self.max_context
        ) or (self.max_context,)
        self._sample_kw = dict(
            do_sample=do_sample, temperature=temperature, top_k=top_k,
            top_p=top_p, approx_top_k=approx_top_k,
        )
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self.per_request_sampling = per_request_sampling
        self.sampling_kmax = sampling_kmax
        self._seed0 = seed
        # engine-wide defaults as per-row values (requests without params)
        if not do_sample or (temperature is not None and temperature == 0):
            self._default_row_sampling = (0.0, 1, 0.0)
        else:
            self._default_row_sampling = (
                float(temperature if temperature is not None else 1.0),
                int(top_k or 0),
                float(top_p or 0.0),
            )

        # physical pool: page 0 is the scratch page inactive rows point at
        n_pages = total_pages if total_pages is not None else (
            max_batch * self.pages_per_row + 1
        )
        #: the pool's kind: a latent pool (one vector a token a layer) for
        #: MLA models, else K/V pages
        self.latent = isinstance(cfg, LatentModelArgs)
        if self.latent:
            if kv_quant is not None:
                raise ValueError("int8 KV pages quantize K and V; a latent pool holds neither")
            self.pool = LatentPagedCache.create_pool(
                cfg.num_layers, n_pages, page_size, cfg.latent_dim,
                dtype=resolve_dtype(cfg.dtype), device=self.device)
            self.scales = None
        else:
            proto = PagedKVCache.create(
                num_layers=cfg.num_layers, batch_size=1,
                max_seq_len=n_pages * page_size, kv_heads=cfg.query_groups,
                head_dim=cfg.head_dim, page_size=page_size,
                dtype=torch.int8 if kv_quant == "int8" else resolve_dtype(cfg.dtype),
                device=self.device,
            )
            self.pool = proto.kv_pages
            self.scales = proto.kv_scales  # None unless int8
        self.allocator = PageAllocator(n_pages)
        self.max_prefill_tokens = max_prefill_tokens
        # bytes a token holds in one layer of the pool (scales included),
        # and the decode window of every windowed layer
        per_page = self.pool[0, 0].numel() * self.pool.element_size()
        if self.scales is not None:
            per_page += self.scales[0, 0].numel() * self.scales.element_size()
        self._token_layer_bytes = per_page // page_size
        self._decode_windows = [w for w in (layer_attention(cfg, i).decode_window
                                            for i in range(cfg.num_layers)) if w >= 0]

        # host-side row state
        self.tables = np.zeros((max_batch, self.pages_per_row), np.int32)
        self.lengths = np.zeros((max_batch,), np.int32)
        self.last_tokens = np.zeros((max_batch,), np.int32)
        # per-row sampling state; inactive rows sit at temperature 0 (greedy)
        self.row_temp = np.zeros((max_batch,), np.float32)
        self.row_topk = np.ones((max_batch,), np.int32)
        self.row_topp = np.zeros((max_batch,), np.float32)
        self.row_seed = np.zeros((max_batch,), np.int64)  # uint32 values
        self.row_request: List[Optional[Request]] = [None] * max_batch
        self.row_pages: List[List[int]] = [[] for _ in range(max_batch)]
        # keys this row holds refs on (cache-owned pages are excluded from
        # allocator.free at retirement)
        self.prefix_cache = PrefixCache() if prefix_caching else None
        self.row_cached_keys: List[List[int]] = [[] for _ in range(max_batch)]
        self.queue: List[Request] = []
        self.preemptions = 0
        self._next_rid = 0
        if decode_block_steps < 1:
            raise ValueError("decode_block_steps must be >= 1")
        self.decode_block_steps = decode_block_steps
        if spec_k:
            if do_sample:
                raise ValueError(
                    "spec_k uses greedy acceptance; do_sample must be False"
                )
            if decode_block_steps > 1:
                raise ValueError("spec_k and decode_block_steps are exclusive")
            if per_request_sampling:
                raise ValueError(
                    "spec_k verification is greedy-only; per-request "
                    "sampling is not supported with speculative decoding"
                )
        if overlap_scheduling and spec_k:
            raise ValueError(
                "overlap_scheduling pipelines plain decode blocks; "
                "speculative decoding drives its own loop"
            )
        self.overlap_scheduling = overlap_scheduling
        #: the queued-but-unprocessed decode block (overlap mode)
        self._inflight = None
        self.spec_k = spec_k
        self.spec_ngram = spec_ngram
        self.spec_proposed = 0
        self.spec_accepted = 0
        #: (bucket, padded group size) of every prefill forward run so far
        self.prefill_shapes = set()
        #: model forwards by kind: 'prefill' (tail prefills), 'decode' (one
        #: token per row), 'verify' (spec_k windows)
        self.forwards = {"prefill": 0, "decode": 0, "verify": 0}

        # the decode blocks' static device buffers (the verify forward reads
        # tables and lengths too): the host state of a block is copied in
        # before it runs
        buf = self._zeros
        self._dev = {
            "tables": buf(torch.int32, max_batch, self.pages_per_row),
            "lengths": buf(torch.int32, max_batch),
            "tokens": buf(torch.int32, max_batch),
            "chain": buf(torch.bool, max_batch),
        }
        if per_request_sampling:
            self._dev.update(self._sampling_buffers(max_batch))
        #: ('prefill', bucket, rpad), ('decode', k) and ('verify',) -> the
        #: graph of that program (every key's buffers in ``graphs.entries``);
        #: the graphs share one side stream and pool
        #: (``graphs.use_graph = False`` runs every program eagerly)
        self.graphs = GraphSet(
            self.device, generator=None if per_request_sampling else self._generator)

    # ---------------- public API ----------------

    def submit(
        self,
        prompt_ids: List[int],
        max_new_tokens: int,
        sampling: Optional[SamplingParams] = None,
    ) -> int:
        if not prompt_ids:
            raise ValueError("empty prompt")
        if sampling is not None and not self.per_request_sampling:
            raise ValueError(
                "per-request SamplingParams require "
                "ServingEngine(per_request_sampling=True)"
            )
        if len(prompt_ids) >= self.max_context:
            raise ValueError(
                f"prompt ({len(prompt_ids)}) >= max_context "
                f"({self.max_context})"
            )
        worst_ctx = min(len(prompt_ids) + max_new_tokens + 1, self.max_context)
        if -(-worst_ctx // self.page_size) > self.allocator.capacity:
            raise ValueError(
                f"request footprint ({worst_ctx} tokens) exceeds the page "
                f"pool ({self.allocator.capacity} pages x {self.page_size})"
            )
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(
            Request(rid, list(prompt_ids), max_new_tokens, sampling=sampling)
        )
        return rid

    def max_prefill_rows(self, bucket: int) -> int:
        """Rows one prefill forward of ``bucket`` takes at most: a power of
        two up to MAX_PREFILL_GROUP whose padded tokens fit the budget."""
        rows = self.MAX_PREFILL_GROUP
        if self.max_prefill_tokens is not None:
            rows = 1
            while (rows * 2 <= self.MAX_PREFILL_GROUP
                   and rows * 2 * bucket <= self.max_prefill_tokens):
                rows *= 2
        return rows

    def kv_window_dead_bytes(self) -> int:
        """K/V bytes the pool holds for windowed layers at positions more
        than the layer's decode window behind their row's length (what a
        pool kept per layer kind could free), from the host's lengths."""
        n = 0
        for row, req in enumerate(self.row_request):
            if req is not None:
                length = int(self.lengths[row])
                n += sum(max(0, length - w) for w in self._decode_windows)
        return n * self._token_layer_bytes

    def kv_bytes_in_use(self) -> int:
        """K/V bytes of the pages the allocator has handed out, every layer."""
        return (self.allocator.num_used * self.page_size * self.cfg.num_layers
                * self._token_layer_bytes)

    def run(self) -> Dict[int, List[int]]:
        """Drive until every submitted request completes; returns
        {rid: generated token ids}."""
        finished: Dict[int, List[int]] = {}
        while (self.queue or any(r is not None for r in self.row_request)
               or self._inflight is not None):
            for req in self.step():
                finished[req.rid] = req.output_ids
        return finished

    def step(self) -> List[Request]:
        """Admit what fits, run one decode block, retire finished rows.

        With ``overlap_scheduling`` the call is pipelined: it queues the
        next decode block (its input tokens taken on the device from the
        previous block's last column) BEFORE reading the previous block's
        tokens, so the host's scheduling and the round trip hide behind the
        device's work."""
        with annotate("serve.admit"):
            self._admit()
        if self.spec_k or not self.overlap_scheduling:
            if not any(r is not None for r in self.row_request):
                return []
            if self.spec_k:
                with annotate("serve.verify"):
                    self._spec_step()
            else:
                self._decode_step()
            return self._retire()

        new_block = None
        if any(r is not None and not r.done for r in self.row_request):
            new_block = self._dispatch_block(chained=self._inflight)
        retired: List[Request] = []
        if self._inflight is not None:
            self._process_block(self._inflight)
            retired = self._retire()
        self._inflight = new_block
        return retired

    # ---------------- internals ----------------

    def _zeros(self, dtype: torch.dtype, *shape: int) -> torch.Tensor:
        """A static buffer on the engine's device."""
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def _sampling_buffers(self, rows: int) -> Dict[str, torch.Tensor]:
        """Static per-row sampling values (per_request_sampling)."""
        buf = self._zeros
        return dict(temp=buf(torch.float32, rows), topk=buf(torch.int32, rows),
                    topp=buf(torch.float32, rows), seed=buf(torch.int64, rows))

    def _sample(self, logits: torch.Tensor, bufs: Dict[str, torch.Tensor],
                positions: torch.Tensor) -> torch.Tensor:
        """The next tokens from [rows, V] logits: per row from the sampling
        values in ``bufs``, keyed by the (seed, position) of each row's draw,
        or from the engine's generator with its engine-wide knobs."""
        if self.per_request_sampling:
            return sample_logits_per_row(
                None, logits, temperature=bufs["temp"], top_k=bufs["topk"],
                top_p=bufs["topp"], row_seeds=bufs["seed"], positions=positions,
                kmax=self.sampling_kmax)
        return sample_logits(self._generator, logits, **self._sample_kw)

    def _fetch(self, t: torch.Tensor):
        """Start copying ``t`` to the host; returns (host tensor, event).
        ``t`` may be a static buffer that the next block overwrites."""
        if t.device.type != "cuda":
            return t.clone(), None
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return host, ev

    @staticmethod
    def _wait(fetched) -> np.ndarray:
        host, ev = fetched
        if ev is not None:
            ev.synchronize()
        return host.numpy()

    def _cache(self, tables: torch.Tensor, lengths: torch.Tensor, fresh: bool = False):
        """The pool as the model's paged cache over ``tables`` and
        ``lengths``; ``fresh``: every row starts at 0, so a latent pool's
        prefill attends its own window and reads no page."""
        if self.latent:
            return LatentPagedCache(self.pool, tables, lengths, fresh=fresh)
        return PagedKVCache(
            kv_pages=self.pool, page_table=tables, lengths=lengths,
            kv_scales=self.scales, head_dim=self.cfg.head_dim,
        )

    def _bucket(self, n: int) -> int:
        for b in self.prompt_buckets:
            if n <= b:
                return b
        # beyond the largest bucket (a preempted continuation's long
        # prompt): round up to 128, capped at max_context
        return min(-(-n // 128) * 128, self.max_context)

    def _admit(self) -> None:
        ready: List[Tuple[int, Request, int, List[int]]] = []
        for row in range(self.max_batch):
            if not self.queue or self.row_request[row] is not None:
                continue
            req = self.queue[0]
            plen = len(req.prompt_ids)
            total_slots = -(-(plen + 1) // self.page_size)  # + first decode
            keys: List[int] = []
            cached_pages: List[int] = []
            if self.prefix_cache is not None:
                keys = PrefixCache.chain_keys(
                    req.prompt_ids, self.page_size, plen // self.page_size
                )
                # the LAST prompt token is always recomputed: its logits
                # seed the first decode
                usable = (plen - 1) // self.page_size
                cached_pages = self.prefix_cache.lookup(keys)[:usable]
            cached_slots = len(cached_pages)
            cached_keys = keys[:cached_slots]
            # pin the matched pages BEFORE any reclaim, or the reclaim could
            # evict exactly the pages this lookup returned
            if cached_keys:
                self.prefix_cache.acquire(cached_keys)
            need = total_slots - cached_slots
            if need > self.allocator.num_free:
                self._reclaim(need - self.allocator.num_free)
            if need > self.allocator.num_free:
                if cached_keys:
                    self.prefix_cache.release(cached_keys)
                break  # head-of-line waits for pages to free
            self.queue.pop(0)
            if self.prefix_cache is not None:
                # stats count admitted prompts only
                self.prefix_cache.query_tokens += plen
                self.prefix_cache.hit_tokens += cached_slots * self.page_size
            pages = cached_pages + self.allocator.alloc(need)
            self.row_pages[row] = pages
            self.tables[row, :] = 0
            self.tables[row, : len(pages)] = pages
            self.row_cached_keys[row] = list(cached_keys)
            self.row_request[row] = req
            sp = req.sampling or SamplingParams(*self._default_row_sampling)
            self.row_temp[row] = sp.temperature
            self.row_topk[row] = sp.top_k
            self.row_topp[row] = sp.top_p
            self.row_seed[row] = (
                sp.seed if sp.seed is not None else (self._seed0 + req.rid)
            ) & 0xFFFFFFFF
            ready.append((row, req, cached_slots * self.page_size, keys))

        # batched admission: one forward per (tail bucket, group)
        groups: Dict[int, List[Tuple[int, Request, int, List[int]]]] = {}
        for item in ready:
            row, req, cached_len, _ = item
            groups.setdefault(self._bucket(len(req.prompt_ids) - cached_len),
                              []).append(item)
        for bucket, items in groups.items():
            per = self.max_prefill_rows(bucket)
            for i in range(0, len(items), per):
                group = items[i:i + per]
                rids = lambda: {"rids": ",".join(str(it[1].rid) for it in group)}  # noqa: E731
                with annotate("serve.prefill", rids):
                    self._prefill_group(bucket, group)

    def _prefill_group(
        self,
        bucket: int,
        items: List[Tuple[int, Request, int, List[int]]],
    ) -> None:
        """Prefill up to ``max_prefill_rows(bucket)`` admitted rows in ONE
        forward.

        Each row's uncached prompt tail runs at its own offset
        (``cached_len``, page-aligned; 0 without a prefix hit): positions
        and causal masks follow the per-row cache lengths.  The group is
        padded to a power of two with scratch rows (one token against the
        scratch page), as in the JAX engine."""
        r = len(items)
        rpad = 1
        while rpad < r:
            rpad *= 2
        ids = np.zeros((rpad, bucket), np.int32)
        mask = np.zeros((rpad, bucket), bool)
        mask[:, 0] = True  # padding rows: one token, committed to scratch
        tables = np.zeros((rpad, self.pages_per_row), np.int32)
        starts = np.zeros((rpad,), np.int32)
        last_idx = np.zeros((rpad,), np.int32)
        for g, (row, req, cached_len, _) in enumerate(items):
            tail = req.prompt_ids[cached_len:]
            ids[g, : len(tail)] = tail
            mask[g, : len(tail)] = True
            tables[g] = self.tables[row]
            starts[g] = cached_len
            last_idx[g] = len(tail) - 1

        inputs = dict(ids=ids, mask=mask, tables=tables, starts=starts,
                      last_idx=last_idx)
        if self.per_request_sampling:  # scratch rows draw greedily
            inputs.update(temp=np.zeros((rpad,), np.float32), topk=np.ones((rpad,), np.int32),
                          topp=np.zeros((rpad,), np.float32), seed=np.zeros((rpad,), np.int64),
                          pos=np.zeros((rpad,), np.int32))
            for g, (row, req, _, _) in enumerate(items):
                for name, arr in (("temp", self.row_temp), ("topk", self.row_topk),
                                  ("topp", self.row_topp), ("seed", self.row_seed)):
                    inputs[name][g] = arr[row]
                inputs["pos"][g] = len(req.prompt_ids)
        self.prefill_shapes.add((bucket, rpad))
        self.forwards["prefill"] += 1
        toks = self.graphs(("prefill", bucket, rpad),
                           lambda: self._prefill_entry(bucket, rpad), inputs)
        with annotate("serve.prefill.wait"):
            toks = self._wait(self._fetch(toks))
        for g, (row, req, cached_len, keys) in enumerate(items):
            plen = len(req.prompt_ids)
            tok = int(toks[g])
            self.lengths[row] = plen
            self.last_tokens[row] = tok
            req.output_ids.append(tok)
            if self.prefix_cache is not None:
                # register the newly written FULL prompt pages (immutable
                # from here on: decode writes at positions >= plen)
                for i in range(cached_len // self.page_size,
                               plen // self.page_size):
                    if self.prefix_cache.insert(keys[i], self.row_pages[row][i]):
                        self.row_cached_keys[row].append(keys[i])
            self._maybe_finish(row, req, tok)

    def _prefill_entry(self, bucket: int, rpad: int):
        """The (bucket, rpad) prefill's static buffers, body and [rpad]
        token output: the tail prefill's forward, its logits at each row's
        last token and the draw of the row's first token."""
        # the body reaches the engine through a weak proxy: the engine owns
        # its graphs, and dropping the engine frees them and its pool at
        # once, not at the next cycle collection
        engine = weakref.proxy(self)
        buf = self._zeros
        bufs = dict(ids=buf(torch.int32, rpad, bucket), mask=buf(torch.bool, rpad, bucket),
                    tables=buf(torch.int32, rpad, self.pages_per_row),
                    starts=buf(torch.int32, rpad), last_idx=buf(torch.int32, rpad))
        if self.per_request_sampling:
            bufs.update(self._sampling_buffers(rpad), pos=buf(torch.int32, rpad))
        out = buf(torch.int32, rpad)
        # without prefix hits every row starts at 0
        fresh = self.prefix_cache is None

        @torch.no_grad()
        def body():
            cache = engine._cache(bufs["tables"], bufs["starts"], fresh)
            logits, _, _ = engine.model(
                bufs["ids"], padding_mask=bufs["mask"], paged_cache=cache,
                readout_positions=bufs["last_idx"],
            )
            out.copy_(engine._sample(logits[:, 0], bufs, bufs.get("pos")))

        return bufs, body, out

    def _ensure_pages(self, lookahead: int = 1, lengths=None) -> None:
        """Map pages for every active row's next ``lookahead`` positions.
        When the pool runs dry the youngest other row is preempted:
        requeued as a continuation (prompt + tokens so far) with its pages
        freed.  ``lengths`` overrides self.lengths (overlap mode passes
        lengths advanced by the block still in flight)."""
        if lengths is None:
            lengths = self.lengths
        for row, req in enumerate(self.row_request):
            if req is None or req.done:
                continue
            slot = (int(lengths[row]) + lookahead - 1) // self.page_size
            while slot >= len(self.row_pages[row]):
                if self.allocator.num_free == 0:
                    self._reclaim(1)  # evict idle cached pages before anyone
                if self.allocator.num_free > 0:
                    page = self.allocator.alloc(1)[0]
                    self.row_pages[row].append(page)
                    # each new page gets its own table entry
                    self.tables[row, len(self.row_pages[row]) - 1] = page
                    continue
                victim = self._pick_victim(exclude=row)
                if victim is None:
                    raise MemoryError("page pool exhausted with no victim")
                self._preempt(victim)

    def _pick_victim(self, exclude: int) -> Optional[int]:
        """Youngest active row (fewest generated tokens) other than
        ``exclude``: it has the least work to replay."""
        best, best_out = None, None
        for row, req in enumerate(self.row_request):
            if req is None or row == exclude:
                continue
            n = len(req.output_ids)
            if best is None or n < best_out:
                best, best_out = row, n
        return best

    def _reclaim(self, n: int) -> None:
        """Return up to ``n`` idle prefix-cache pages to the allocator."""
        if self.prefix_cache is not None and n > 0:
            pages = self.prefix_cache.reclaim(n)
            if pages:
                self.allocator.free(pages)

    def _free_row(self, row: int) -> None:
        """Drop a row's refs on shared prefix pages (they park in the LRU)
        and return its private pages to the allocator."""
        pc = self.prefix_cache
        if pc is not None and self.row_cached_keys[row]:
            pc.release(self.row_cached_keys[row])
            self.row_cached_keys[row] = []
        self.allocator.free(
            [p for p in self.row_pages[row] if pc is None or not pc.owns(p)]
        )
        self.row_pages[row] = []
        self.tables[row, :] = 0
        self.lengths[row] = 0
        self.last_tokens[row] = 0
        self.row_temp[row] = 0.0
        self.row_topk[row] = 1
        self.row_topp[row] = 0.0
        self.row_seed[row] = 0
        self.row_request[row] = None

    def _preempt(self, row: int) -> None:
        self.preemptions += 1
        req = self.row_request[row]
        cont = Request(
            rid=req.rid,
            prompt_ids=req.prompt_ids + req.output_ids,
            max_new_tokens=req.max_new_tokens - len(req.output_ids),
            carried=req.carried + req.output_ids,
            # position-keyed draws resume the same stream
            sampling=req.sampling,
        )
        self.queue.insert(0, cont)
        self._free_row(row)

    @torch.no_grad()
    def _decode_body(self, k: int, out: torch.Tensor) -> None:
        """k decode forwards over the static buffers, each sampling the next
        token on the device into column i of ``out``."""
        dev = self._dev
        cache = self._cache(dev["tables"], dev["lengths"])  # advanced in place
        tokens = dev["tokens"]
        for i in range(k):
            logits, cache, _ = self.model(tokens[:, None], paged_cache=cache)
            # cache.lengths (advanced) is the position the sampled token will
            # occupy: the key of a row's draw
            tokens = self._sample(logits[:, 0], dev, cache.lengths)
            out[:, i] = tokens

    def _decode_block(self, k: int) -> torch.Tensor:
        """Run one k-step block on what the static buffers hold; returns its
        [B, k] tokens (the static output, not yet on the host)."""

        def build():
            engine = weakref.proxy(self)  # as in _prefill_entry
            out = self._zeros(torch.int32, self.max_batch, k)
            return {}, lambda: engine._decode_body(k, out), out

        out = self.graphs(("decode", k), build)
        self.forwards["decode"] += k
        return out

    def _dispatch_block(self, chained=None):
        """Queue one k-step decode block; returns it unfetched.

        ``chained`` is the block still in flight: lengths are advanced by
        its k for the rows it decodes, and their input tokens are its last
        column, on the device.  Returns None (the pipeline drains) when a
        chained block cannot run safely (context margin thinner than k)."""
        with annotate("serve.dispatch"):
            k = self.decode_block_steps
            lengths = self.lengths.copy()
            chain_mask = np.zeros((self.max_batch,), bool)
            if chained is not None:
                for row, req in chained["rows"]:
                    if self.row_request[row] is req:
                        lengths[row] += chained["k"]
                        chain_mask[row] = True
            margin = min(
                (self.max_context - 1 - int(lengths[row])
                 for row, req in enumerate(self.row_request)
                 if req is not None and not req.done),
                default=k,
            )
            if margin < k:
                if chained is not None:
                    return None  # drain first; the sequential fallback handles it
                k = 1
            self._ensure_pages(lookahead=k, lengths=lengths)
            # Every copy below and the block itself run in the order of one
            # stream.  The block in flight (``chained``) was queued before them
            # with the copy of its output to the host right behind it: that
            # copy, and the read of its last column here, both come before this
            # block overwrites the output (a block of the same length replays
            # into the same static buffer), and the copies into the inputs come
            # after the block in flight has read them.
            dev = self._dev
            copy_to_static(dev["tables"], self.tables)
            copy_to_static(dev["lengths"], lengths)
            copy_to_static(dev["tokens"], self.last_tokens)
            if chained is not None:
                copy_to_static(dev["chain"], chain_mask)
                dev["tokens"].copy_(torch.where(dev["chain"], chained["out"][:, -1],
                                                dev["tokens"]))
            if self.per_request_sampling:
                for name, arr in (("temp", self.row_temp), ("topk", self.row_topk),
                                  ("topp", self.row_topp), ("seed", self.row_seed)):
                    copy_to_static(dev[name], arr)
            out = self._decode_block(k)
            return {
                "out": out,
                "host": self._fetch(out),
                "k": k,
                "rows": [
                    (row, req) for row, req in enumerate(self.row_request)
                    if req is not None and not req.done
                ],
            }

    def _process_block(self, block) -> None:
        """Read a block's tokens and commit them to the rows it decoded,
        keyed on request identity: a row retired, preempted or re-admitted
        since the block was queued drops its lane."""
        with annotate("serve.block_wait"):
            out = self._wait(block["host"])  # [B, k]
        with annotate("serve.commit"):
            for row, req in block["rows"]:
                if self.row_request[row] is not req or req.done:
                    continue
                for j in range(block["k"]):
                    # tokens past EOS/budget stay uncounted (never attended,
                    # and overwritten by this row's next real commits)
                    self.lengths[row] += 1
                    tok = int(out[row, j])
                    self.last_tokens[row] = tok
                    req.output_ids.append(tok)
                    self._maybe_finish(row, req, tok)
                    if req.done:
                        break

    def _decode_step(self) -> None:
        self._process_block(self._dispatch_block())

    def _draft(self, context: List[int]) -> List[int]:
        """Prompt-lookup draft: match the tail n-gram (n = spec_ngram down
        to 1) against the row's own history and propose the k tokens that
        followed its latest earlier occurrence."""
        k = self.spec_k
        for n in range(min(self.spec_ngram, len(context) - 1), 0, -1):
            tail = context[-n:]
            for i in range(len(context) - n - 1, -1, -1):
                if context[i:i + n] == tail:
                    cont = context[i + n:i + n + k]
                    return (cont + [cont[-1]] * k)[:k]
        return [context[-1]] * k

    def _spec_step(self) -> None:
        kp1 = self.spec_k + 1
        margin = min(
            (self.max_context - 1 - int(self.lengths[row])
             for row, req in enumerate(self.row_request)
             if req is not None and not req.done),
            default=0,
        )
        if margin < kp1:
            self._decode_step()  # single step; spec forbids blocks > 1
            return
        self._ensure_pages(lookahead=kp1)
        drafts = np.zeros((self.max_batch, kp1), np.int32)
        drafts[:, 0] = self.last_tokens
        for row, req in enumerate(self.row_request):
            if req is None or req.done:
                continue
            drafts[row, 1:] = self._draft(req.prompt_ids + req.output_ids)
            self.spec_proposed += self.spec_k

        # one forward over [B, k+1] verifies every draft (the nonzero-offset
        # prefill path); rejected drafts need no rollback: their commits lie
        # at positions >= the corrected length and are overwritten before
        # they come into range
        self.forwards["verify"] += 1
        nxt = self.graphs(("verify",), self._verify_entry,
                          dict(tables=self.tables, lengths=self.lengths, drafts=drafts))
        nxt = self._wait(self._fetch(nxt))
        for row, req in enumerate(self.row_request):
            if req is None or req.done:
                continue
            for j in range(kp1):
                # iteration j accounts the commit of drafts[row, j] and reads
                # the model's prediction for the next position
                self.lengths[row] += 1
                tok = int(nxt[row, j])
                self.last_tokens[row] = tok
                req.output_ids.append(tok)
                self._maybe_finish(row, req, tok)
                if req.done:
                    break
                if j < self.spec_k and tok == int(drafts[row, j + 1]):
                    self.spec_accepted += 1
                    continue
                break  # the first correction ends this row's window

    def _verify_entry(self):
        """The verify forward's buffers (the decode blocks' tables and
        lengths, which spec_k never runs in blocks, and its own drafts), body
        and [B, spec_k + 1] output: the forward, then the greedy tokens."""
        engine = weakref.proxy(self)  # as in _prefill_entry
        kp1 = self.spec_k + 1
        bufs = dict(tables=self._dev["tables"], lengths=self._dev["lengths"],
                    drafts=self._zeros(torch.int32, self.max_batch, kp1))
        nxt = self._zeros(torch.int32, self.max_batch, kp1)

        @torch.no_grad()
        def body():
            tokens = bufs["drafts"]
            logits, _, _ = engine.model(
                tokens, padding_mask=torch.ones_like(tokens, dtype=torch.bool),
                paged_cache=engine._cache(bufs["tables"], bufs["lengths"]),
            )
            nxt.copy_(torch.argmax(logits, dim=-1))

        return bufs, body, nxt

    def _maybe_finish(self, row: int, req: Request, tok: int) -> None:
        hit_eos = self.eos_token_id is not None and tok == self.eos_token_id
        # the final sampled token is reported but never committed to KV
        if hit_eos or len(req.output_ids) >= req.max_new_tokens or (
            int(self.lengths[row]) + 1 >= self.max_context
        ):
            req.done = True

    def _retire(self) -> List[Request]:
        out = []
        with annotate("serve.retire"):
            for row, req in enumerate(self.row_request):
                if req is not None and req.done:
                    if req.carried:
                        req.output_ids = req.carried + req.output_ids
                        req.carried = []
                    out.append(req)
                    self._free_row(row)
        return out
