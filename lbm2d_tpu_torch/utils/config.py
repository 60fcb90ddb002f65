"""Runtime config utilities: YAML loading, ROI/sponge zone geometry, per-case
metadata upsert.

Parity targets: reference utils/config_utils.py (load_config:9,
get_zone_config:22, save_case_metadata:52). Same YAML schema and zone
rectangle math; JSON writes are always routed through the numpy-safe encoder.
"""

from __future__ import annotations

import json
import os
from datetime import datetime
from typing import Any, Dict

from ..io.json_utils import NumpySafeJSONEncoder


def load_config(path: str) -> Dict[str, Any]:
    """Load a YAML config; raises FileNotFoundError instead of sys.exit."""
    import yaml

    with open(path, "r", encoding="utf-8") as fh:
        return yaml.safe_load(fh)


def save_config(config: Dict[str, Any], path: str) -> None:
    import yaml

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", encoding="utf-8") as fh:
        yaml.safe_dump(config, fh, sort_keys=False, allow_unicode=True)


def get_zone_config(config: Dict[str, Any]) -> Dict[str, int]:
    """ROI rectangle = domain minus sponge layers minus safety buffer."""
    nx = config["simulation"]["nx"]
    ny = config["simulation"]["ny"]
    z = config["domain_zones"]
    buffer = z["buffer"]
    return {
        "sponge_in": z["sponge_in"],
        "sponge_out": z["sponge_out"],
        "sponge_top": z["sponge_top"],
        "sponge_bot": z["sponge_bot"],
        "roi_x_start": z["sponge_in"] + buffer,
        "roi_x_end": nx - z["sponge_out"] - buffer,
        "roi_y_start": z["sponge_bot"] + buffer,
        "roi_y_end": ny - z["sponge_top"] - buffer,
        "nx": nx,
        "ny": ny,
    }


def save_case_metadata(json_path: str, case_id: str, metadata: Dict[str, Any]) -> None:
    """Upsert one case's metadata into an aggregate JSON keyed by case_id."""
    data: Dict[str, Any] = {}
    if os.path.exists(json_path):
        try:
            with open(json_path, "r", encoding="utf-8") as fh:
                data = json.load(fh)
        except (json.JSONDecodeError, IOError):
            data = {}
    metadata = dict(metadata)
    metadata["_updated_at"] = datetime.now().strftime("%Y-%m-%d %H:%M:%S")
    data[case_id] = metadata
    os.makedirs(os.path.dirname(json_path) or ".", exist_ok=True)
    with open(json_path, "w", encoding="utf-8") as fh:
        json.dump(data, fh, cls=NumpySafeJSONEncoder, indent=4, ensure_ascii=False)
