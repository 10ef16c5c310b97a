"""Plugin framework: builtin and external codec module registration.

The port of nvimagecodec_tpu/core/plugin_framework.py, the counterpart of
the modelled library's PluginFramework (src/plugin_framework.cpp:94-433:
extension discovery from NVIMGCODEC_EXTENSIONS_PATH, entry-symbol load;
src/builtin_modules.cpp:25-34: builtin parser extension).

Extensions are Python modules exposing `register(registry)`. External ones
are discovered from the port's own environment variable,
`TPUIMGCODEC_TORCH_EXTENSIONS_PATH` (colon-separated import paths or `.py`
file paths), so that one process can hold both packages without loading an
extension of one into the other. A leading `~` in an entry's name disables
it, as in the modelled library (src/plugin_framework.cpp:281-284); an
extension that fails to load is logged and skipped.
"""
from __future__ import annotations

import importlib
import importlib.util
import os
import sys

from .logger import get_logger
from .registry import CodecRegistry

log = get_logger(__name__)

EXTENSIONS_PATH_VAR = "TPUIMGCODEC_TORCH_EXTENSIONS_PATH"


def register_builtin_modules(registry: CodecRegistry) -> None:
    """Register the port's parsers and codec plugins, then the extensions
    (the modelled library's director registers builtin parsers, then
    discovers extensions, src/nvimgcodec_director.cpp:30-66)."""
    from ..codecs import register_port_codecs

    register_port_codecs(registry)
    discover_and_load_extensions(registry)


def _load(entry: str):
    name = os.path.basename(entry)
    if os.path.isfile(entry) and entry.endswith(".py"):
        spec = importlib.util.spec_from_file_location(
            f"tpuimgcodec_torch_ext_{name[:-3]}", entry)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
        return mod
    return importlib.import_module(entry)


def discover_and_load_extensions(registry: CodecRegistry) -> None:
    """Load the extensions named in TPUIMGCODEC_TORCH_EXTENSIONS_PATH into
    `registry`, each once (the modelled library's discoverAndLoadExtModules,
    src/plugin_framework.cpp:286-307)."""
    seen = set()
    for entry in filter(None, os.environ.get(EXTENSIONS_PATH_VAR,
                                             "").split(":")):
        if os.path.basename(entry).startswith("~"):  # disabled
            log.info("extension %s disabled by ~ prefix", entry)
            continue
        if entry in seen:
            continue
        seen.add(entry)
        try:
            mod = _load(entry)
            entry_fn = getattr(mod, "register", None)
            if entry_fn is None:
                log.warning("extension %s has no register(registry) entry",
                            entry)
                continue
            entry_fn(registry)
            log.info("loaded extension %s", entry)
        except Exception as e:  # logged and skipped (:314-351)
            log.warning("failed to load extension %s: %s", entry, e)
