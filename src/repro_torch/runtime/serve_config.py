"""ServeConfig: the consolidated, serializable serving configuration.

A copy of ``repro.runtime.serve_config`` (same frozen dataclass tree,
same JSON round trip) with two changes for the port:

- ``attn_impl`` takes ``full`` (the grouped-einsum decode attention) or
  ``kernel`` (the hand-written decode-attention kernel on the card, its
  plain PyTorch version on the CPU); the default is ``kernel``;
- ``sched.swap_mode`` takes ``auto`` | ``kernel`` | ``plain``
  (``kernels/ops.py``).

Sections:

- ``ServeConfig``  — core knobs (slots, max_seq, attn_impl,
  prefill_chunk) plus the sub-configs below,
- ``SchedConfig``  — scheduler policy (turn budgets, aging, SLO clock,
  swap mode, AdapterCache byte budget),
- ``KVConfig``     — KV-cache layout (dense vs paged, page geometry,
  prefix sharing),
- ``SpecConfig``   — self-speculative decoding (draft length,
  adaptive backoff),
- ``FleetConfig``  — fleet routing/elasticity knobs.

The port's ``DecodeServer`` serves the dense layout without speculation
or AdapterCache; it raises ``NotImplementedError`` for configs that ask
for those (ROADMAP queue A).  ``to_json``/``from_json`` round-trip
bit-exactly (``ServeConfig.from_json(cfg.to_json()) == cfg``).
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Union

SERVE_CONFIG_VERSION = 1
ATTN_IMPLS = ("full", "kernel")
SWAP_MODES = ("auto", "kernel", "plain")


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


@dataclass(frozen=True)
class SchedConfig:
    """Scheduler policy knobs (see serve_loop.py for semantics).

    ``aging_steps=0`` means auto (``3 * steps_per_turn``), matching the
    legacy ``aging_steps=None`` default.  ``ms_per_step`` is the SLO
    clock: a float pins the decode-step cost in milliseconds
    (deterministic tests/benches), the string ``"auto"`` calibrates it
    from a wall-clock EMA.  ``cache_bytes > 0`` turns on the HBM
    AdapterCache tier.
    """
    steps_per_turn: int = 8
    adapter_aware: bool = True
    aging_steps: int = 0                     # 0 = auto
    ms_per_step: Union[float, str] = 1.0     # float | "auto"
    swap_mode: str = "auto"
    cache_bytes: int = 0

    def __post_init__(self):
        _check(self.steps_per_turn >= 1, "steps_per_turn must be >= 1")
        _check(self.aging_steps >= 0, "aging_steps must be >= 0 (0=auto)")
        _check(self.cache_bytes >= 0, "cache_bytes must be >= 0")
        _check(self.swap_mode in SWAP_MODES,
               f"swap_mode must be one of {SWAP_MODES}, "
               f"got {self.swap_mode!r}")
        if isinstance(self.ms_per_step, str):
            _check(self.ms_per_step == "auto",
                   f"ms_per_step must be a float or 'auto', "
                   f"got {self.ms_per_step!r}")
        else:
            _check(self.ms_per_step > 0, "ms_per_step must be > 0")


@dataclass(frozen=True)
class KVConfig:
    """KV-cache layout: dense ``[slots, max_seq]`` rows or PagedKV.

    ``pages=0`` means auto (dense-equivalent page count); a smaller
    value oversubscribes slots against aggregate tokens.
    """
    layout: str = "dense"                    # "dense" | "paged"
    page_size: int = 16
    pages: int = 0                           # 0 = auto
    prefix_share: bool = True

    def __post_init__(self):
        _check(self.layout in ("dense", "paged"),
               f"kv layout must be 'dense' or 'paged', got {self.layout!r}")
        _check(self.page_size >= 1, "page_size must be >= 1")
        _check(self.pages >= 0, "pages must be >= 0 (0=auto)")


@dataclass(frozen=True)
class SpecConfig:
    """Self-speculative decoding: ``draft=0`` disables it; ``adaptive``
    backs the per-tenant draft length off when acceptance drops."""
    draft: int = 0
    adaptive: bool = True

    def __post_init__(self):
        _check(self.draft >= 0, "spec draft length must be >= 0")


@dataclass(frozen=True)
class FleetConfig:
    """Fleet routing, elasticity and failure-tolerance knobs
    (``runtime/fleet.py`` + ``runtime/elastic.py``).

    Health: ``ReplicaHealth`` keeps a per-replica EMA of round step
    time; a replica past ``slow_threshold`` x the fleet median EMA
    (after ``warmup_rounds`` observed rounds) is flagged a straggler,
    and one that makes no progress for ``wedge_rounds`` consecutive
    rounds while holding work is **fenced** (removed from the ring,
    its requests replayed on peers).  ``spill_depth=0`` and
    ``vnodes`` mirror the pre-config Router kwargs.  ``read_retries``
    / ``retry_backoff_ms`` bound the retry-with-backoff wrapper around
    transient adapter-registry reads.  ``replace_after_fence`` spawns a
    fresh replica for every fenced one (the kill-and-replace drill).
    """
    vnodes: int = 64
    spill_depth: int = 0              # 0 = auto (2x batch_slots)
    ema_alpha: float = 0.3
    slow_threshold: float = 3.0       # x fleet-median step-time EMA
    wedge_rounds: int = 3
    warmup_rounds: int = 2
    read_retries: int = 3
    retry_backoff_ms: float = 5.0
    replace_after_fence: bool = False

    def __post_init__(self):
        _check(self.vnodes >= 1, "vnodes must be >= 1")
        _check(self.spill_depth >= 0, "spill_depth must be >= 0 (0=auto)")
        _check(0.0 < self.ema_alpha <= 1.0,
               "ema_alpha must be in (0, 1]")
        _check(self.slow_threshold > 1.0, "slow_threshold must be > 1")
        _check(self.wedge_rounds >= 1, "wedge_rounds must be >= 1")
        _check(self.warmup_rounds >= 0, "warmup_rounds must be >= 0")
        _check(self.read_retries >= 1, "read_retries must be >= 1")
        _check(self.retry_backoff_ms >= 0,
               "retry_backoff_ms must be >= 0")


@dataclass(frozen=True)
class ServeConfig:
    """The full serving configuration — the unit a fleet replicates."""
    batch_slots: int = 4
    max_seq: int = 256
    attn_impl: str = "kernel"
    prefill_chunk: int = 64
    sched: SchedConfig = field(default_factory=SchedConfig)
    kv: KVConfig = field(default_factory=KVConfig)
    spec: SpecConfig = field(default_factory=SpecConfig)
    fleet: FleetConfig = field(default_factory=FleetConfig)

    def __post_init__(self):
        _check(self.batch_slots >= 1, "batch_slots must be >= 1")
        _check(self.max_seq >= 2, "max_seq must be >= 2")
        _check(self.prefill_chunk >= 0, "prefill_chunk must be >= 0")
        _check(self.attn_impl in ATTN_IMPLS,
               f"attn_impl must be one of {ATTN_IMPLS}, "
               f"got {self.attn_impl!r}")
        # coerce plain dicts (the from_json path and lazy callers)
        if isinstance(self.sched, dict):
            object.__setattr__(self, "sched", SchedConfig(**self.sched))
        if isinstance(self.kv, dict):
            object.__setattr__(self, "kv", KVConfig(**self.kv))
        if isinstance(self.spec, dict):
            object.__setattr__(self, "spec", SpecConfig(**self.spec))
        if isinstance(self.fleet, dict):
            object.__setattr__(self, "fleet", FleetConfig(**self.fleet))

    # ------------------------------------------------------------------ #
    # serialization
    # ------------------------------------------------------------------ #

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["version"] = SERVE_CONFIG_VERSION
        return d

    def to_json(self) -> str:
        """Canonical JSON (sorted keys, 1-space indent) — stable under
        round-trip: ``ServeConfig.from_json(cfg.to_json()) == cfg``."""
        return json.dumps(self.to_dict(), indent=1, sort_keys=True) + "\n"

    @classmethod
    def from_dict(cls, d: dict) -> "ServeConfig":
        d = dict(d)
        version = d.pop("version", SERVE_CONFIG_VERSION)
        _check(version == SERVE_CONFIG_VERSION,
               f"unsupported ServeConfig version {version} "
               f"(this build reads v{SERVE_CONFIG_VERSION})")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        _check(not unknown, f"unknown ServeConfig keys: {sorted(unknown)}")
        sub = {"sched": SchedConfig, "kv": KVConfig, "spec": SpecConfig,
               "fleet": FleetConfig}
        kw = {}
        for k, v in d.items():
            if k in sub and isinstance(v, dict):
                sub_known = {f.name for f in dataclasses.fields(sub[k])}
                sub_unknown = set(v) - sub_known
                _check(not sub_unknown,
                       f"unknown {k} keys: {sorted(sub_unknown)}")
                kw[k] = sub[k](**v)
            else:
                kw[k] = v
        return cls(**kw)

    @classmethod
    def from_json(cls, text: str) -> "ServeConfig":
        return cls.from_dict(json.loads(text))

    def replace(self, **kw) -> "ServeConfig":
        return dataclasses.replace(self, **kw)
