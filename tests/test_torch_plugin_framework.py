"""The port's plugin framework (core/plugin_framework.py) on the CPU: the
twin of tests/test_core.py::test_debug_messenger_fires_on_runtime_fallback
on a registry built by `register_builtin_modules`, and extension discovery
from TPUIMGCODEC_TORCH_EXTENSIONS_PATH: a `.py` file and an import path
load, a `~` entry is skipped, a broken entry is logged and skipped, and the
JAX package's variable is left alone."""
import logging
import os
import subprocess
import sys
import textwrap

import oracle
import nvimagecodec_tpu_torch as port
from nvimagecodec_tpu_torch.core import plugin_framework as pf
from nvimagecodec_tpu_torch.core.interfaces import DecodeResult
from nvimagecodec_tpu_torch.core.types import ProcessingStatus
from util import make_photo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VAR = "TPUIMGCODEC_TORCH_EXTENSIONS_PATH"

_EXTENSION = textwrap.dedent("""
    from nvimagecodec_tpu_torch.codecs.bmp import BmpDecoder

    class MarkedDecoder(BmpDecoder):
        plugin_id = "{name}_decoder"

    def register(registry):
        registry.codec("{name}").register_decoder(MarkedDecoder())
""")


def _write(tmp_path, name, text):
    path = tmp_path / f"{name}.py"
    path.write_text(text)
    return str(path)


def _decoder_ids(reg, codec):
    return [d.plugin_id for d in reg.codec(codec).decoders]


def test_debug_messenger_fires_on_runtime_fallback(monkeypatch):
    """The scheduler reports a per-sample runtime fallback through the
    messenger chain, on a registry the plugin framework built."""
    monkeypatch.delenv(VAR, raising=False)

    class FlakyDecoder:
        plugin_id = "flaky_test_decoder"
        codec_name = "jpeg"
        backend_kind = port.BackendKind.HYBRID_CPU_GPU
        priority = -1000  # outrank everything

        def set_options(self, opts):
            pass

        def can_decode(self, data, infos, params):
            return [ProcessingStatus.SUCCESS] * len(data)

        def decode_batch(self, data, infos, params):
            return [DecodeResult(ProcessingStatus.FAIL, error="flaky")] * len(
                data)

    reg = port.CodecRegistry()
    pf.register_builtin_modules(reg)
    reg.codec("jpeg").register_decoder(FlakyDecoder())

    msgs = []
    h = port.register_debug_messenger(
        lambda sev, cat, data: msgs.append((int(cat), data.codec_id)),
        severities=int(port.DebugMessageSeverity.ALL),
    )
    try:
        img = make_photo(16, 16, seed=3)
        out = port.Decoder(device="cpu", registry=reg).decode(
            oracle.jpeg_encode(img, 90, "420"))
        assert out is not None  # fallback decoded it
    finally:
        port.unregister_debug_messenger(h)
    assert any(
        cat & int(port.DebugMessageCategory.PLUGIN)
        and cid == "flaky_test_decoder" for cat, cid in msgs)


def test_extensions_load_disable_and_skip_failures(tmp_path, monkeypatch,
                                                   caplog):
    good = _write(tmp_path, "goodext", _EXTENSION.format(name="goodfmt"))
    off = _write(tmp_path, "~offext", _EXTENSION.format(name="offfmt"))
    broken = _write(tmp_path, "brokenext", "raise RuntimeError('boom')\n")
    bare = _write(tmp_path, "bareext", "x = 1\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    (tmp_path / "modext.py").write_text(_EXTENSION.format(name="modfmt"))
    monkeypatch.setenv(VAR, ":".join(
        [broken, good, off, bare, "modext", "no_such_module_here", good]))
    reg = port.CodecRegistry()
    with caplog.at_level(logging.INFO):
        pf.register_builtin_modules(reg)
    assert _decoder_ids(reg, "goodfmt") == ["goodfmt_decoder"]  # once
    assert _decoder_ids(reg, "modfmt") == ["modfmt_decoder"]
    assert "offfmt" not in [c.name for c in reg.codecs()]
    # the builtin codecs are all there beside them
    assert "cuda_jpeg_hybrid_decoder" in _decoder_ids(reg, "jpeg")
    text = caplog.text
    assert "failed to load extension" in text and "boom" in text
    assert "no_such_module_here" in text
    assert "has no register(registry) entry" in text
    assert "disabled by ~ prefix" in text


def test_global_registry_reads_the_ports_own_variable(tmp_path):
    """In a fresh process: global_registry() loads the extension named in
    TPUIMGCODEC_TORCH_EXTENSIONS_PATH and not the one in the JAX package's
    TPUIMGCODEC_EXTENSIONS_PATH."""
    mine = _write(tmp_path, "mineext", _EXTENSION.format(name="minefmt"))
    theirs = _write(tmp_path, "theirsext",
                    _EXTENSION.format(name="theirsfmt"))
    script = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {REPO!r})
        import nvimagecodec_tpu_torch as port
        reg = port.global_registry()
        names = [c.name for c in reg.codecs()]
        assert "minefmt" in names, names
        assert "theirsfmt" not in names, names
        assert port.port_registry() is reg
        print("OK")
    """)
    env = dict(os.environ, **{VAR: mine, "TPUIMGCODEC_EXTENSIONS_PATH": theirs})
    r = subprocess.run([sys.executable, "-c", script], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-2000:]
