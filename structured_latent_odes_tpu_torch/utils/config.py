"""Attribute-dict configuration: a copy of the JAX package's ``utils/config.py``.

Kept as a copy because importing any module of the JAX package pulls in JAX.
"""

from __future__ import annotations

import json
from typing import Any


class Config(dict):
    """A dict with attribute access, recursively wrapping nested dicts."""

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        for k, v in list(self.items()):
            if isinstance(v, dict) and not isinstance(v, Config):
                self[k] = Config(v)

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:  # pragma: no cover - attribute protocol
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        if isinstance(value, dict) and not isinstance(value, Config):
            value = Config(value)
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as e:  # pragma: no cover
            raise AttributeError(name) from e

    def copy(self) -> "Config":
        return Config({k: (v.copy() if isinstance(v, Config) else v) for k, v in self.items()})

    def to_json(self, **kwargs: Any) -> str:
        def default(o: Any) -> Any:
            if hasattr(o, "tolist"):
                return o.tolist()
            return str(o)

        return json.dumps(self, default=default, **kwargs)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        return cls(json.loads(s))

