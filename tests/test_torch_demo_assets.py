"""The port's demo renderer (``amw_tpu_torch/scripts/gen_demo_assets.py``)
against the JAX package's script (``scripts/gen_demo_assets.py``) on the
CPU: the same synthesized clips, one clip mastered by the port's chain and
by the JAX package's within -90 dBFS, the four WAVs it writes, and the
service's start of the render where the clips are missing, on the
engine's device.

One 8 s clip through each chain costs a few seconds here, so the whole
clip is compared (the JAX script's ``DUR``).
"""

import asyncio
import importlib.util
import threading
from pathlib import Path

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from amw_tpu_torch.runtime import db as tdb
from amw_tpu_torch.runtime import service
from amw_tpu_torch.runtime.engine import MasteringEngine
from amw_tpu_torch.scripts import gen_demo_assets as demo
from amw_tpu_torch.utils import wav

ROOT = Path(__file__).resolve().parent.parent
PARITY_DBFS = -90.0


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_gen_demo_assets", ROOT / "scripts" / "gen_demo_assets.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_clips():
    """Both clips as the JAX script synthesizes and prepares them (its own
    synth functions, one generator in turn, as its ``main`` does)."""
    js = _jax_script()
    g = np.random.default_rng(js.SEED)
    n = int(js.DUR * js.SR)
    t = np.arange(n) / js.SR
    out = []
    for name, synth in (("edm", js._edm), ("ballad", js._ballad)):
        x = js._stereoize(synth(g, t, n), g)
        x = np.clip(x / max(np.abs(x).max(), 1e-9) * 0.35, -1, 1)
        out.append((name, (x - x.mean(axis=-1, keepdims=True)).astype(
            np.float32)))
    return js, out


def test_constants_and_clips_equal_the_jax_scripts(jax_clips):
    js, clips = jax_clips
    assert (demo.SR, demo.DUR, demo.SEED) == (js.SR, js.DUR, js.SEED)
    ours = demo.source_clips()
    assert [n for n, _ in ours] == [n for n, _ in clips] == ["edm", "ballad"]
    for (_, a), (_, b) in zip(ours, clips):
        assert a.dtype == np.float32 and a.shape == (2, int(demo.DUR
                                                           * demo.SR))
        np.testing.assert_array_equal(a, b)


def test_render_matches_the_jax_chain(jax_clips):
    """The edm clip through the port's chain on the CPU and through the
    JAX package's ``compile_chain`` at the script's settings."""
    from amw_tpu.models.chain import compile_chain
    from amw_tpu.spec import GraphSpec

    js, clips = jax_clips
    x = clips[0][1]
    spec = GraphSpec(sr=js.SR, n=x.shape[-1], channels=2)
    want = np.asarray(compile_chain(spec, None, target_lufs=-14.0,
                                    style="standard")(x))
    got = demo.master(x, device="cpu")
    assert got.shape == want.shape and np.all(np.isfinite(got))
    err_db = 20 * np.log10(max(float(np.max(np.abs(got - want))), 1e-30))
    assert err_db <= PARITY_DBFS, err_db
    # the written int16 samples: a rounding step apart at most
    assert np.max(np.abs(demo.to_int16(got).astype(np.int32)
                         - demo.to_int16(want))) <= 1


def test_render_writes_the_four_wavs(tmp_path):
    out = demo.render(tmp_path, device="cpu")
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ballad_mastered.wav", "ballad_original.wav", "edm_mastered.wav",
        "edm_original.wav"]
    for name, (x, mastered) in out.items():
        for tag, buf in (("original", x), ("mastered", mastered)):
            y, sr = wav.read_wav((tmp_path / f"{name}_{tag}.wav")
                                 .read_bytes())
            assert sr == demo.SR and y.shape == buf.shape
            np.testing.assert_array_equal(
                np.round(y * 32768).astype(np.int16), demo.to_int16(buf))
        assert np.abs(mastered).max() > np.abs(x).max()


def test_service_renders_missing_clips_on_the_engines_device(
        tmp_path, monkeypatch):
    """Served without the clips, the app starts one render in a thread on
    its engine's device; with them there it starts none."""
    calls = []
    done = threading.Event()

    def fake_render(out_dir=None, device="cuda"):
        calls.append((out_dir, device))
        (demo.DEMO_DIR / "edm_mastered.wav").write_bytes(b"")
        done.set()

    monkeypatch.setattr(demo, "DEMO_DIR", tmp_path / "demos")
    (tmp_path / "demos").mkdir()
    monkeypatch.setattr(demo, "render", fake_render)
    tdb.set_db_path(str(tmp_path / "port.sqlite3"))
    eng = MasteringEngine(device="cpu")

    async def serve():
        app = service.create_app(eng)
        async with TestClient(TestServer(app)):
            th = app["demo_render"]
            assert th is not None and th.name == "demo-assets"
        th.join(30)
        app = service.create_app(eng)
        async with TestClient(TestServer(app)):
            assert app["demo_render"] is None

    loop = asyncio.new_event_loop()
    try:
        loop.run_until_complete(serve())
    finally:
        loop.close()
        eng.close()
    assert done.is_set() and calls == [(None, eng.device)]


def test_service_render_failure_is_logged(tmp_path, monkeypatch, caplog):
    """A failed render is logged and leaves the service up (demos are
    cosmetic)."""
    def broken(out_dir=None, device="cuda"):
        raise RuntimeError("no card")

    monkeypatch.setattr(demo, "DEMO_DIR", tmp_path)
    monkeypatch.setattr(demo, "render", broken)
    th = service.start_demo_render("cpu")
    th.join(30)
    assert not th.is_alive()
    assert any("demo clip render failed" in r.getMessage()
               and r.exc_info for r in caplog.records)
