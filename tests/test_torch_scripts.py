"""The port's operator CLIs (``amw_tpu_torch/scripts/``) against the JAX
package's scripts (``scripts/``) on the CPU: the host meters
(``qa/gates.py``) against ``refimpl``'s, the self-diagnosis, the file
master, the regression fixture, the production entry, and every CLI's
refusal to run without a GPU unless given ``--device cpu``.

Each JAX script is loaded by path and its ``main`` run with a patched
``sys.argv``; every run works in a temporary directory, on temporary
databases.
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from amw_tpu_torch.scripts import (gen_api_docs, gen_regression_fixture,
                                   gen_sep_eval, run_audio_test, run_debug,
                                   run_diagnose_file, run_isolate_vocal,
                                   run_production, run_self_diagnosis,
                                   run_test_master)
from amw_tpu_torch.utils import wav

ROOT = Path(__file__).resolve().parent.parent
SR = 44100
PARITY_DBFS = -90.0
LU_TOL = 0.1
METER_TOL = 0.01
LSB_TOL = 2.0  # tests/test_torch_runtime_io.py: TPDF draws differ


def jax_script(name: str, path: Path | None = None):
    path = path or ROOT / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"jax_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax(mod, argv, monkeypatch, capsys):
    """The JAX script's ``main`` under ``sys.argv``: (return, stdout)."""
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", [mod.__file__, *argv])
    rc = mod.main()
    return rc, capsys.readouterr().out


def run_port(main, argv, capsys):
    capsys.readouterr()
    rc = main(argv)
    return rc, capsys.readouterr().out


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU paths here are many small ops: one intra-op thread
    keeps them from spinning against the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    """A temporary working directory, both packages' databases in it."""
    from amw_tpu.runtime import db as jdb
    from amw_tpu_torch.runtime import db as tdb

    for mod, name in ((jdb, "jax"), (tdb, "torch")):
        monkeypatch.setattr(mod, "_db_path_cache", None)
        mod.set_db_path(str(tmp_path / f"{name}.sqlite3"))
    monkeypatch.setenv("MM_REGRESSION_WAV", str(tmp_path / "regression.wav"))
    monkeypatch.chdir(tmp_path)
    return tmp_path


def write_wav16(path: Path, x: np.ndarray) -> None:
    q = np.round(np.clip(x, -1, 1) * 32767.0).astype(np.int16)
    path.write_bytes(wav.write_wav_int16(q, SR))


def read_wav(path: Path) -> np.ndarray:
    return wav.read_wav(path.read_bytes())[0]


def dbfs(err: float) -> float:
    return 20 * np.log10(max(err, 1e-30))


# --- the host meters --------------------------------------------------------


@pytest.mark.parametrize("which", ["stereo_12s", "mono_3s"])
def test_gates_match_refimpl(which):
    from amw_tpu import refimpl
    from amw_tpu_torch.qa import gates

    x = run_self_diagnosis.make_track()
    if which == "mono_3s":
        x = x[:1, :3 * SR]
    assert abs(gates.integrated_lufs(x, SR, device="cpu")
               - refimpl.integrated_lufs(x, SR)) <= METER_TOL
    assert abs(gates.true_peak_dbfs(x, SR, device="cpu")
               - refimpl.true_peak_dbfs(x, SR)) <= METER_TOL
    got = gates.normalize_lufs(x, SR, -14.0, device="cpu")
    want = refimpl.normalize_lufs(x, SR, -14.0)
    assert got.dtype == np.float32
    assert dbfs(float(np.max(np.abs(got - want)))) <= PARITY_DBFS


def test_gates_on_silence_follow_refimpl():
    from amw_tpu import refimpl
    from amw_tpu_torch.qa import gates

    x = np.zeros((2, SR), np.float32)
    assert gates.integrated_lufs(x, SR, device="cpu") \
        == refimpl.integrated_lufs(x, SR) == float("-inf")
    np.testing.assert_array_equal(
        gates.normalize_lufs(x, SR, -14.0, device="cpu"), x)


# --- self-diagnosis ---------------------------------------------------------


def _diag_rows(out: str) -> dict:
    rows = {}
    for line in out.splitlines():
        f = line.split()
        if len(f) >= 11 and f[1] == "target":
            rows[f[0]] = (float(f[2]), float(f[4]), float(f[7]), f[-1])
    return rows


def test_self_diagnosis_matches_jax(workdir, monkeypatch, capsys):
    from amw_tpu.constants import PRESET_LUFS
    from amw_tpu.models.pipeline_v1 import master_v1

    js = jax_script("run_self_diagnosis")
    np.testing.assert_array_equal(run_self_diagnosis.make_track(),
                                  js.make_track())
    rc_j, out_j = run_jax(js, [], monkeypatch, capsys)
    rc_t, out_t = run_port(run_self_diagnosis.main, ["--device", "cpu"],
                           capsys)
    assert rc_j == rc_t == 0
    assert out_t.splitlines()[-1] == out_j.splitlines()[-1] \
        == "All self-diagnosis gates passed."
    rows_j, rows_t = _diag_rows(out_j), _diag_rows(out_t)
    assert list(rows_t) == list(rows_j) == list(PRESET_LUFS)
    for preset, (target, lufs, tp, verdict) in rows_t.items():
        tj, lj, pj, vj = rows_j[preset]
        assert (target, verdict) == (tj, vj) == (PRESET_LUFS[preset], "OK")
        assert abs(lufs - lj) <= LU_TOL and abs(tp - pj) <= LU_TOL
    # one preset's samples against the JAX package's master_v1
    x = run_self_diagnosis.make_track()
    r = run_self_diagnosis.diagnose("club", x, SR, "cpu")
    want = np.asarray(master_v1(x, SR, target_lufs=PRESET_LUFS["club"],
                                style="standard"))
    assert r["ok"]
    assert dbfs(float(np.max(np.abs(r["out"] - want)))) <= PARITY_DBFS


# --- the file master --------------------------------------------------------


def test_test_master_matches_jax(workdir, monkeypatch, capsys):
    x = run_self_diagnosis.make_track(dur=6.0)
    write_wav16(workdir / "in.wav", x)
    js = jax_script("run_test_master")
    rc_j, out_j = run_jax(js, ["in.wav", "j.wav", "--preset", "apple"],
                          monkeypatch, capsys)
    rc_t, out_t = run_port(run_test_master.main,
                           ["in.wav", "t.wav", "--preset", "apple",
                            "--device", "cpu"], capsys)
    assert rc_j == rc_t == 0
    lj, lt = out_j.splitlines(), out_t.splitlines()
    assert lt[0] == lj[0]  # the input's meters
    assert lt[2] == "wrote t.wav" and lj[2] == "wrote j.wav"
    assert lt[1].startswith("mastered in ") and "x realtime), " in lt[1]
    # the output meters of the "mastered" line: LUFS and TP
    tail_j = lj[1].split("realtime), ")[1]
    tail_t = lt[1].split("realtime), ")[1]
    (lufs_j, tp_j), (lufs_t, tp_t) = (
        (float(s.split()[0]), float(s.split()[3])) for s in (tail_j, tail_t))
    assert abs(lufs_t - lufs_j) <= LU_TOL and abs(tp_t - tp_j) <= LU_TOL
    a, b = read_wav(workdir / "t.wav"), read_wav(workdir / "j.wav")
    assert a.shape == b.shape == x.shape
    assert float(np.max(np.abs(a - b))) * 32768.0 <= LSB_TOL


# --- the regression fixture -------------------------------------------------


@pytest.fixture(scope="module")
def fixture_runs(tmp_path_factory):
    """Each package's ``main`` run once in a directory of its own: the
    WAV it wrote and what it printed."""
    import contextlib
    import io
    import os

    js = jax_script("gen_regression_fixture")
    out = {}
    cwd = os.getcwd()
    for name, run in (("jax", lambda: js.main()),
                      ("torch", lambda: gen_regression_fixture.main([]))):
        d = tmp_path_factory.mktemp(name)
        buf = io.StringIO()
        try:
            os.chdir(d)
            with contextlib.redirect_stdout(buf):
                run()
        finally:
            os.chdir(cwd)
        out[name] = (d / gen_regression_fixture.OUT, buf.getvalue())
    return js, out


def test_regression_fixture_matches_jax(fixture_runs):
    js, out = fixture_runs
    assert (gen_regression_fixture.SR, gen_regression_fixture.DUR,
            gen_regression_fixture.SEED) == (js.SR, js.DUR, js.SEED)
    audio = gen_regression_fixture.render()
    np.testing.assert_array_equal(audio, js.render())
    assert audio.dtype == np.float32 and audio.shape == (2, int(js.DUR
                                                              * js.SR))
    (path_j, said_j), (path_t, said_t) = out["jax"], out["torch"]
    assert said_t == said_j
    assert path_t.read_bytes() == path_j.read_bytes()
    x, sr = wav.read_wav(path_t.read_bytes())
    np.testing.assert_array_equal(np.round(x * 32768.0).astype(np.int16),
                                  gen_regression_fixture.to_int16(audio))


def test_regression_fixture_is_the_harness_fixture(fixture_runs,
                                                   monkeypatch):
    """``main`` writes where the harness looks for the fixture, relative
    to the repository's root, and ``regression_wav_path`` finds it."""
    from amw_tpu_torch.qa import mastering_regression as tmr

    _, out = fixture_runs
    assert tmr._FIXTURES.relative_to(ROOT) == \
        gen_regression_fixture.OUT.parent
    path = out["torch"][0]
    monkeypatch.setenv("MM_REGRESSION_WAV", str(path))
    assert tmr.regression_wav_path() == path
    assert wav.read_wav(path.read_bytes())[1] == gen_regression_fixture.SR


# --- the production entry ---------------------------------------------------


def test_run_production_passes_host_and_port(monkeypatch):
    from amw_tpu_torch.runtime import service

    calls = []
    monkeypatch.setattr(service, "main",
                        lambda **kw: calls.append(kw))
    monkeypatch.setenv("AMW_HOST", "127.0.0.7")
    monkeypatch.setenv("AMW_PORT", "8123")
    assert run_production.main(["--device", "cpu"]) == 0
    monkeypatch.delenv("AMW_HOST")
    monkeypatch.delenv("AMW_PORT")
    assert run_production.main(["--device", "cpu"]) == 0
    dev = torch.device("cpu")
    assert calls == [{"host": "127.0.0.7", "port": 8123, "device": dev},
                     {"host": "0.0.0.0", "port": 8000, "device": dev}]
    # the JAX script's defaults
    text = (ROOT / "scripts" / "run_production.py").read_text()
    assert 'os.environ.get("AMW_HOST", "0.0.0.0")' in text
    assert 'os.environ.get("AMW_PORT", "8000")' in text


# --- no GPU -----------------------------------------------------------------


def _cli_calls(tmp: Path) -> dict:
    wav_in = str(tmp / "in.wav")
    return {
        "run_self_diagnosis": lambda: run_self_diagnosis.main([]),
        "run_test_master": lambda: run_test_master.main(
            [wav_in, str(tmp / "out.wav")]),
        "run_audio_test": lambda: run_audio_test.main([]),
        "run_diagnose_file": lambda: run_diagnose_file.main([wav_in]),
        "run_isolate_vocal": lambda: run_isolate_vocal.main(
            [wav_in, str(tmp / "v.wav")]),
        "run_isolate_vocal_htdemucs": lambda: run_isolate_vocal.main(
            [wav_in, str(tmp / "v.wav"), "--model", "htdemucs",
             "--weights", "bundled"]),
        "run_debug": lambda: run_debug.main([]),
        "gen_api_docs": lambda: gen_api_docs.main(
            ["--out", str(tmp / "API.md")]),
        "gen_sep_eval": lambda: gen_sep_eval.main([]),
        "gen_sep_eval_call": lambda: gen_sep_eval.eval_checkpoint(batch=1),
        "run_production": lambda: run_production.main([]),
    }


@pytest.mark.parametrize("name", sorted(_cli_calls(Path("."))))
def test_cli_raises_without_a_gpu(name, workdir, monkeypatch):
    from amw_tpu_torch.runtime import engine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(engine, "_default_engine", None)
    monkeypatch.delenv("AMW_HTDEMUCS_CKPT", raising=False)
    monkeypatch.delenv("AMW_HTDEMUCS_DTYPE", raising=False)
    write_wav16(workdir / "in.wav", np.zeros((2, SR), np.float32))
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        _cli_calls(workdir)[name]()
    assert not (workdir / "out.wav").exists()
    assert not (workdir / "test_output_v1.wav").exists()


def test_every_cli_has_a_main_and_a_device_switch():
    """Each module named here runs as ``python -m`` with ``main(argv)``
    and takes ``--device``; the fixture generator runs on no device."""
    for mod in (run_self_diagnosis, run_test_master, run_audio_test,
                run_diagnose_file, run_isolate_vocal, run_debug,
                gen_api_docs, gen_sep_eval, run_production):
        src = Path(mod.__file__).read_text()
        assert "def main(argv=None) -> int:" in src, mod.__name__
        assert '"--device"' in src and "resolve_device(" in src, mod.__name__
        assert 'if __name__ == "__main__":' in src, mod.__name__
    assert "def main(argv=None) -> int:" in Path(
        gen_regression_fixture.__file__).read_text()
