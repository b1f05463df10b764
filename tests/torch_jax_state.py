"""Locates the moments in a live JAX optax state, for the port's tests that
hold a carried or resumed optimizer state against the JAX package's.

Test helper only — not product code.
"""

from __future__ import annotations

from typing import Any


def jax_moments(opt_state: Any) -> dict[str, Any]:
    """The moment trees of a live optax state under the port's names: Adam's
    ``mu`` and ``nu`` (optax's ``ScaleByAdamState`` or the JAX package's
    ``scale_by_adam_moment_dtypes``), LARS's ``mu`` and SGD's ``trace`` (the
    port's ``mu``), found in its NamedTuples wherever the options put them
    in the chain."""
    found: dict[str, Any] = {}

    def walk(node):
        if hasattr(node, "_asdict"):
            fields = node._asdict()
            for name, port in (("mu", "mu"), ("nu", "nu"), ("trace", "mu")):
                if isinstance(fields.get(name), dict):
                    found.setdefault(port, fields[name])
            node = list(fields.values())
        if isinstance(node, (list, tuple)):
            for child in node:
                walk(child)

    walk(opt_state)
    return found
