"""``pw.persistence`` — user-facing persistence config (parity:
python/pathway/persistence/__init__.py:27-88).

Backends: filesystem / s3 (gated) / mock (in-memory, for tests).  The engine
side lives in ``pathway_tpu_torch/engine/persistence.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any


class Backend:
    kind: str = "abstract"

    def __init__(self):
        self._store: Any = None

    @classmethod
    def filesystem(cls, path: str) -> "Backend":
        b = cls()
        b.kind = "filesystem"
        b.path = path
        return b

    @classmethod
    def s3(cls, root_path: str, bucket_settings: Any = None) -> "Backend":
        b = cls()
        b.kind = "s3"
        b.path = root_path
        b.bucket_settings = bucket_settings
        return b

    @classmethod
    def gcs(cls, root_path: str, **kw) -> "Backend":
        """Google Cloud Storage persistence.  ``root_path`` is
        ``gs://bucket/prefix``; ambient GCE/TPU-VM metadata identity by
        default, or pass ``token_provider=`` / ``endpoint=`` (emulator) /
        a pre-built ``client=``."""
        b = cls()
        b.kind = "gcs"
        b.path = root_path
        b.token_provider = kw.get("token_provider")
        b.endpoint = kw.get("endpoint")
        b.client = kw.get("client")
        b.prefix = kw.get("prefix", "")
        return b

    @classmethod
    def azure(cls, root_path: str, account: Any = None, **kw) -> "Backend":
        """Azure Blob persistence.  ``root_path`` is ``az://container/prefix``;
        ``account`` is ``{"account_name", "account_key", "endpoint"?}`` (the
        endpoint override targets emulators), or pass ``client=`` in ``kw``
        with a pre-built ``AzureBlobClient`` plus optional ``prefix=``."""
        b = cls()
        b.kind = "azure"
        b.path = root_path
        b.account = account
        b.client = kw.get("client")
        b.prefix = kw.get("prefix", "")
        return b

    @classmethod
    def mock(cls, events: Any = None) -> "Backend":
        b = cls()
        b.kind = "mock"
        b.events = events
        b.store = {}
        return b


@dataclasses.dataclass
class Config:
    """Persistence config (parity: persistence/__init__.py:88)."""

    backend: Backend | None = None
    snapshot_interval_ms: int = 0
    snapshot_access: Any = None
    persistence_mode: Any = None
    continue_after_replay: bool = True

    @classmethod
    def simple_config(cls, backend: Backend, **kwargs) -> "Config":
        return cls(backend=backend, **kwargs)

    # pathway >=0.8 style: Config(backend, ...)
    def __init__(
        self,
        backend: Backend | None = None,
        *,
        snapshot_interval_ms: int = 0,
        snapshot_access: Any = None,
        persistence_mode: Any = None,
        continue_after_replay: bool = True,
    ):
        self.backend = backend
        self.snapshot_interval_ms = snapshot_interval_ms
        self.snapshot_access = snapshot_access
        self.persistence_mode = persistence_mode
        self.continue_after_replay = continue_after_replay


__all__ = ["Backend", "Config"]
