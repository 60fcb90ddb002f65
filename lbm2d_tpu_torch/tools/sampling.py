"""Config-driven random sampling helper (reference tools/config_utils.py:3-30).

[a, b]      -> uniform sample (randint if both ints)
[a, b, ...] -> random choice
scalar      -> identity
"""

from __future__ import annotations

import random
from typing import Any, Optional


def get_sampled_value(param_value: Any, rng: Optional[random.Random] = None) -> Any:
    """Sample ``param_value`` with ``rng`` (a fresh generator when None)."""
    r = rng or random.Random()
    if not isinstance(param_value, list):
        return param_value
    if len(param_value) == 2:
        lo, hi = param_value
        if isinstance(lo, (int, float)) and isinstance(hi, (int, float)) and lo <= hi:
            if isinstance(lo, int) and isinstance(hi, int):
                return r.randint(lo, hi)
            return r.uniform(lo, hi)
        # non-numeric pair (e.g. ["aligned", "staggered"]): random choice.
        # (The reference returns None here, which crashes downstream; treating
        # it as a choice is the only usable interpretation.)
        return r.choice(param_value)
    if len(param_value) > 2:
        return r.choice(param_value)
    if len(param_value) == 1:
        return param_value[0]
    return None
