"""Free-form plugin options string parsing.

Reference mechanism: a space-separated options string of
"<plugin_id>:<key>=<value>" entries passed at decoder/encoder creation and
parsed by each plugin — e.g. `nvjpeg_cuda_decoder:hybrid_huffman_threshold=
1000000` (extensions/nvjpeg/cuda_decoder.cpp:188-209) or
`nvjpeg2k_cuda_decoder:num_parallel_tiles=16`
(extensions/nvjpeg2k/cuda_decoder.cpp:178-195).
"""
from __future__ import annotations

from typing import Dict


def parse_options(options: str) -> Dict[str, Dict[str, str]]:
    """"a:k=v b:k2=v2" → {"a": {"k": "v"}, "b": {"k2": "v2"}}."""
    out: Dict[str, Dict[str, str]] = {}
    for tok in options.split():
        if ":" not in tok or "=" not in tok:
            continue
        plugin, kv = tok.split(":", 1)
        k, v = kv.split("=", 1)
        out.setdefault(plugin, {})[k] = v
    return out


def get_int(opts: Dict[str, str], key: str, default: int) -> int:
    try:
        return int(opts.get(key, default))
    except (TypeError, ValueError):
        return default


def get_bool(opts: Dict[str, str], key: str, default: bool) -> bool:
    v = opts.get(key)
    if v is None:
        return default
    return v.lower() in ("1", "true", "yes", "on")
