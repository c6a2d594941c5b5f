"""Inference pools: static least-loaded selection + elastic membership
(reference: utils/client.py:30-166 InferencePool/StaticInferencePool,
utils/elastic.py:106-507 ElasticInferencePool).

The orchestrator assigns each rollout *group* to one engine (prefix-cache
affinity) using assignment-count least-loaded selection. The elastic pool
re-reads a discovery source (url list file or DNS name) on ``sync()``,
health-checks members, drops dead engines, and brings joiners up to the
current policy before admitting them (reference: elastic.py weight resync).
"""

from __future__ import annotations

import asyncio
import socket
from dataclasses import dataclass, field
from pathlib import Path

from prime_rl_tpu_torch.envs.client import InferenceClient
from prime_rl_tpu_torch.utils.logger import get_logger


@dataclass
class PoolMember:
    client: InferenceClient
    inflight: int = 0
    healthy: bool = True
    # serving adapters already reconciled onto this engine (elastic pool)
    adapters: set = field(default_factory=set)

    @property
    def base_url(self) -> str:
        return self.client.base_url


class StaticInferencePool:
    def __init__(self, base_urls: list[str], timeout: float = 1200.0):
        self.members = [PoolMember(InferenceClient(u, timeout)) for u in base_urls]

    @property
    def clients(self) -> list[InferenceClient]:
        return [m.client for m in self.members if m.healthy]

    def pick(self) -> PoolMember:
        healthy = [m for m in self.members if m.healthy] or self.members
        m = min(healthy, key=lambda m: m.inflight)
        m.inflight += 1
        return m

    def release(self, base_url: str) -> None:
        for m in self.members:
            if m.base_url == base_url and m.inflight > 0:
                m.inflight -= 1
                return

    def quarantine(self, base_url: str) -> bool:
        """Mark an engine unhealthy so pick()/clients skip it (e.g. a failed
        weight update would leave it serving a stale policy). Refuses to
        quarantine the last healthy member — returns False in that case.
        An elastic pool's sync() re-admits the engine once it passes health
        checks again (and re-syncs weights/adapters on the way in)."""
        healthy = [m for m in self.members if m.healthy]
        for m in healthy:
            if m.base_url == base_url:
                if len(healthy) <= 1:
                    return False
                m.healthy = False
                return True
        return True  # already gone

    async def wait_live(self, timeout: float = 1800.0) -> dict:
        """Block until every member answers /liveness; returns the max-version
        liveness payload. Generous default: engines may warm up (pre-compile
        serving programs) before binding — many minutes on remote runtimes."""
        best: dict = {}
        for m in self.members:
            deadline = asyncio.get_event_loop().time() + timeout
            while True:
                try:
                    live = await m.client.liveness()
                    if live.get("policy_version", -1) >= best.get("policy_version", -1):
                        best = live
                    break
                except Exception:
                    if asyncio.get_event_loop().time() > deadline:
                        raise TimeoutError(f"{m.base_url} never became live")
                    await asyncio.sleep(1.0)
        return best


class ElasticInferencePool(StaticInferencePool):
    """Discovers members from a source; ``sync()`` reconciles membership."""

    def __init__(self, discovery: str, port: int = 8000, timeout: float = 1200.0,
                 weight_dir_fn=None):
        super().__init__([], timeout)
        self.discovery = discovery
        self.port = port
        self.timeout = timeout
        self.weight_dir_fn = weight_dir_fn  # version -> weight dir (joiner sync)
        self.current_version = -1
        # desired serving-adapter state, reconciled onto joiners (reference:
        # utils/elastic.py:250-400 per-server LoRA adapter reconciliation)
        self.adapters: dict[str, str] = {}  # name -> path

    def register_adapter(self, name: str, path: str) -> None:
        """Declare an adapter every pool member must serve; loaded onto
        current members on the next sync and onto every future joiner."""
        self.adapters[name] = path

    def unregister_adapter(self, name: str) -> None:
        self.adapters.pop(name, None)

    async def _reconcile_adapters(self, client) -> None:
        for name, path in self.adapters.items():
            await client.load_lora_adapter(name, path)

    def _discover(self) -> list[str]:
        if self.discovery.startswith("file://"):
            path = Path(self.discovery[len("file://"):])
            if not path.exists():
                return []
            return [l.strip() for l in path.read_text().splitlines() if l.strip()]
        if self.discovery.startswith("dns://"):
            name = self.discovery[len("dns://"):]
            try:
                _, _, addrs = socket.gethostbyname_ex(name)
            except OSError:
                return []
            return [f"http://{a}:{self.port}" for a in sorted(addrs)]
        return [u.strip() for u in self.discovery.split(",") if u.strip()]

    async def sync(self) -> None:
        logger = get_logger()
        urls = set(self._discover())
        known = {m.base_url for m in self.members}
        # health-check existing + reconcile late-registered adapters
        for m in list(self.members):
            try:
                await m.client.liveness()
                if not m.healthy:
                    # rejoining after quarantine/outage: it may be serving a
                    # stale policy — re-sync weights BEFORE readmission
                    if self.weight_dir_fn is not None and self.current_version >= 0:
                        await m.client.update_weights(
                            str(self.weight_dir_fn(self.current_version)),
                            self.current_version)
                    logger.info(f"elastic: re-admitted {m.base_url} "
                                f"(re-synced to v{self.current_version})")
                m.healthy = True
                missing = {n: p for n, p in self.adapters.items()
                           if n not in getattr(m, "adapters", set())}
                if missing:
                    for name, path in missing.items():
                        await m.client.load_lora_adapter(name, path)
                    m.adapters = getattr(m, "adapters", set()) | set(missing)
                    logger.info(
                        f"elastic: reconciled adapters {sorted(missing)} on {m.base_url}")
            except Exception:
                m.healthy = False
                if m.base_url not in urls:
                    self.members.remove(m)
                    logger.info(f"elastic: dropped dead engine {m.base_url}")
        # admit joiners (after syncing them to the current policy + adapters)
        for url in urls - known:
            client = InferenceClient(url, self.timeout)
            try:
                await client.liveness()
                if self.weight_dir_fn is not None and self.current_version >= 0:
                    await client.update_weights(
                        str(self.weight_dir_fn(self.current_version)), self.current_version
                    )
                await self._reconcile_adapters(client)
                member = PoolMember(client)
                member.adapters = set(self.adapters)
                self.members.append(member)
                logger.info(f"elastic: admitted engine {url} (v{self.current_version})")
            except Exception as e:
                logger.debug(f"elastic: candidate {url} not ready: {e}")
