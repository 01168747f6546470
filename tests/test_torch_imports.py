"""The port stands alone: no JAX, nothing of ``amw_tpu``, GPU by default."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "amw_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_amw_tpu_import(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "amw_tpu"), f"{path}: {mod}"


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from amw_tpu_torch import GraphSpec, resolve_device
    from amw_tpu_torch.convert import htdemucs_from_jax, params_from_jax
    from amw_tpu_torch.models import build_v1_pipeline, htdemucs, master_v1
    from amw_tpu_torch.models import vocal

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    # the htdemucs network's entry points, with the checkpoint configured
    monkeypatch.setenv("AMW_HTDEMUCS_CKPT", "bundled")
    cfg = htdemucs.tiny_config()
    state = htdemucs.init_params(cfg)
    mix = np.zeros((2, cfg.segment_samples), np.float32)
    for call in (lambda: htdemucs.inference_model(cfg, state, device=None),
                 lambda: htdemucs.separate(state, mix, cfg),
                 lambda: htdemucs_from_jax(
                     {k: v.numpy() for k, v in state.items()}, cfg),
                 lambda: vocal.separate_htdemucs(mix, cfg.samplerate),
                 lambda: vocal.warmup_htdemucs((180.0,)),
                 lambda: vocal.isolate_vocal(mix, cfg.samplerate)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    spec = GraphSpec(sr=44100, n=44100, channels=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_v1_pipeline(spec)
    with pytest.raises(RuntimeError, match="CUDA"):
        master_v1(np.zeros((2, 44100), np.float32), 44100)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax([np.zeros(3, np.float32)])
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch or raise; the plain versions run only
    because a tensor lies on the CPU."""
    from amw_tpu_torch.ops import fdfilter, scan
    from amw_tpu_torch.ops import fft_staged as fs

    x = torch.zeros(2, 100)
    with pytest.raises(ValueError):
        fdfilter.box_smooth_cuda(x, 5)
    with pytest.raises(ValueError):
        scan.env_gain_cuda(x, torch.full((2,), 100, dtype=torch.int32),
                           0, 100, 1, 0.9, 0.99, 0.5, 3.0, 0.35)
    nfft = 1 << 19
    y = torch.zeros(2, nfft)
    tabs = fs._device_tables(nfft, torch.device("cpu"))
    with pytest.raises(ValueError):
        fs.stage_a_cuda(y, y, nfft, False, tabs)
    with pytest.raises(ValueError):
        fs.inv_join_cuda(y, y, 1, nfft, tabs)
    with pytest.raises(ValueError):
        fs.bccb_multi_cuda(y, y, torch.zeros(1, 2, nfft), nfft, tabs)
    with pytest.raises(ValueError):
        fs.reduce_packed_cuda(y, y, 1, 2, nfft, torch.zeros(1, 8), tabs)


def test_v2_modules_are_checked():
    """The no-JAX check above covers the v2 job's modules."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("models/chain.py", "models/v2_job.py", "ops/exciter.py",
                "ops/stereo.py", "ops/dynamics.py", "ops/scan.py"):
        assert f"amw_tpu_torch/{mod}" in names, mod


def test_v2_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from amw_tpu_torch import GraphSpec
    from amw_tpu_torch.models import build_v2_job_graph, compile_chain

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = GraphSpec(sr=44100, n=44100, channels=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_v2_job_graph(spec, None)
    with pytest.raises(RuntimeError, match="CUDA"):
        compile_chain(spec)


def test_new_kernel_wrappers_refuse_cpu_tensors():
    from amw_tpu_torch.ops import scan
    from amw_tpu_torch.ops import fft_staged as fs

    x = torch.zeros(2, 100)
    with pytest.raises(ValueError):
        scan.env_scan_cuda(x, 0, 100, 1, 0.9, 0.99)
    with pytest.raises(ValueError):
        scan.env_rows_cuda(x, 0.9, 0.99)
    nfft = 1 << 19
    y = torch.zeros(2, nfft)
    tabs = fs._device_tables(nfft, torch.device("cpu"))
    with pytest.raises(ValueError):
        fs.bc_cb_cuda(y, y, torch.zeros(2, nfft), nfft, tabs)
    with pytest.raises(ValueError):
        fs.reduce_cuda(y, y, 1, 2, nfft, torch.zeros(1, 8), tabs)


def test_slice4_modules_are_checked():
    """The no-JAX check above covers the analysis suite and the split
    stages' kernel source is bound."""
    from amw_tpu_torch.ops import _cuda

    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("models/analyze.py", "ops/meters.py", "ops/fft_staged.py"):
        assert f"amw_tpu_torch/{mod}" in names, mod
    for entry in ("amw_fft_bc", "amw_fft_cb", "amw_fft_cb_multi"):
        stem, _ = _cuda._ENTRIES[entry]
        assert (_cuda.CSRC / f"{stem}.cu").read_text().count(
            f'extern "C" int {entry}(') == 1, entry


def test_split_kernel_wrappers_refuse_cpu_tensors():
    from amw_tpu_torch.ops import fft_staged as fs

    nfft = 1 << 19
    y = torch.zeros(2, nfft)
    tabs = fs._device_tables(nfft, torch.device("cpu"))
    with pytest.raises(ValueError):
        fs.bc_cuda(y, y, nfft, tabs)
    for resp in (torch.zeros(2, nfft), None):
        with pytest.raises(ValueError):
            fs.cb_cuda(y, y, resp, nfft, tabs)
    with pytest.raises(ValueError):
        fs.cb_multi_cuda(y, y, torch.zeros(2, 2, nfft), nfft, tabs)


def test_finish_modules_are_checked():
    """The no-JAX check above covers the last DSP options and the vocal
    separator."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("ops/tplimit.py", "ops/reverb.py", "ops/dither.py",
                "ops/fdfilter.py", "ops/exciter.py", "models/vocal.py"):
        assert f"amw_tpu_torch/{mod}" in names, mod


def test_finish_entry_points_default_to_cuda_and_raise_without_it(
        monkeypatch):
    from amw_tpu_torch import GraphSpec
    from amw_tpu_torch.models import vocal
    from amw_tpu_torch.ops import dither

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("AMW_HTDEMUCS_CKPT", raising=False)
    spec = GraphSpec(sr=44100, n=44100, channels=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        vocal.build_vocal_isolation(spec, device=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        vocal.isolate_vocal(np.zeros((2, 4096), np.float32), 44100)
    with pytest.raises(RuntimeError, match="CUDA"):
        dither.dither_noise(torch.Generator(), (2, 100))


def test_runtime_modules_are_checked():
    """The no-JAX check above covers the serving runtime and the host
    helpers under it."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("runtime/engine.py", "runtime/batcher.py",
                "runtime/progress.py", "runtime/config.py",
                "utils/wav.py", "utils/audio_io.py", "parallel/batch.py",
                "native/__init__.py", "native/build.py"):
        assert f"amw_tpu_torch/{mod}" in names, mod


def test_runtime_entry_points_default_to_cuda_and_raise_without_it(
        monkeypatch):
    from amw_tpu_torch.models import vocal
    from amw_tpu_torch.runtime import engine
    from amw_tpu_torch.utils import wav

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(engine, "_default_engine", None)
    monkeypatch.delenv("AMW_HTDEMUCS_CKPT", raising=False)
    for micro_batch in (True, False):
        with pytest.raises(RuntimeError, match="CUDA"):
            engine.MasteringEngine(micro_batch=micro_batch)
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.get_engine()
    data = wav.write_wav_float32(np.zeros((2, 4096), np.float32), 44100)
    with pytest.raises(RuntimeError, match="CUDA"):
        vocal.isolate_vocal_bytes(data, "t.wav")
    assert engine.MasteringEngine(micro_batch=False,
                                  device="cpu").device == torch.device("cpu")


def test_native_codecs_build_from_the_port_sources():
    """The port loads the libraries it builds from its own ``native/*.cpp``
    into ``amw_tpu_torch/_build/``, none from ``amw_tpu/native``."""
    from amw_tpu_torch import native

    build_dir = ROOT / "amw_tpu_torch" / "_build"
    for name, get in (("pcm", native.get_lib),
                      ("flac", native.get_flac_lib)):
        lib = get()
        if lib is None:
            pytest.skip("g++ cannot build the native codecs here")
        path = Path(lib._name).resolve()
        assert path.parent == build_dir and path.name.startswith(
            f"lib{name}-"), path
        assert path == native.build.target(name)
        assert (ROOT / "amw_tpu_torch" / "native" / f"{name}.cpp").is_file()


def test_service_modules_are_checked():
    """The no-JAX check above covers the HTTP service and the modules
    under it."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("runtime/service.py", "runtime/db.py",
                "runtime/settings_store.py", "runtime/auth.py",
                "runtime/users.py", "runtime/deps.py", "runtime/jobs.py",
                "runtime/share_card.py", "runtime/server_metrics.py",
                "runtime/notifier.py", "runtime/anomaly.py",
                "runtime/knowledge.py", "runtime/ai.py", "utils/trace.py",
                "utils/metadata.py", "utils/png.py"):
        assert f"amw_tpu_torch/{mod}" in names, mod


def test_service_defaults_to_cuda_and_raises_without_it(monkeypatch,
                                                        tmp_path):
    from amw_tpu_torch.runtime import db, engine, service

    db.set_db_path(str(tmp_path / "t.sqlite3"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(engine, "_default_engine", None)
    with pytest.raises(RuntimeError, match="CUDA"):
        service.create_app()
    with pytest.raises(RuntimeError, match="CUDA"):
        service.main(port=0)


def test_mesh_modules_are_checked():
    """The no-JAX check above covers the serving mesh, the time-sharded
    path and the regression harness."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("parallel/mesh.py", "parallel/batch.py",
                "parallel/timeshard.py", "qa/mastering_regression.py",
                "qa/__init__.py", "models/htdemucs.py"):
        assert f"amw_tpu_torch/{mod}" in names, mod


def test_mesh_entry_points_default_to_cuda_and_raise_without_it(
        monkeypatch):
    from amw_tpu_torch.parallel import batch, mesh
    from amw_tpu_torch.parallel.timeshard import sp_master
    from amw_tpu_torch.qa import mastering_regression

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((2, 44100), np.float32)
    for call in (lambda: mesh.make_mesh(), lambda: mesh.make_mesh2d(1, 2),
                 lambda: mesh.make_pod_mesh(),
                 lambda: mesh.make_mesh(devices=["cuda:0", "cuda:0"]),
                 lambda: batch.batch_master(x[None], 44100),
                 lambda: sp_master(x, 44100, mesh.make_mesh()),
                 lambda: mastering_regression.run_default_chain_stages(
                     x, 44100)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
