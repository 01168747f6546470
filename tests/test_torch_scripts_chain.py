"""The port's chain and service CLIs against the JAX package's scripts on
the CPU: the audio smoke test (v1 and the default v2 chain), the
stage-by-stage file diagnosis, the vocal isolation with both models, and
the API reference from the route table.  The helpers are
``tests/test_torch_scripts.py``'s.
"""

import os
import re
import shutil

import numpy as np
import pytest

from amw_tpu_torch.scripts import (gen_api_docs, run_audio_test,
                                   run_diagnose_file, run_isolate_vocal,
                                   run_self_diagnosis)
from test_torch_scripts import (LSB_TOL, LU_TOL, ROOT, jax_script,
                                one_torch_thread, read_wav, run_jax, run_port,
                                workdir, write_wav16)

# the fixtures, imported for this module's tests
__all__ = ["one_torch_thread", "workdir"]


def test_audio_test_matches_jax(workdir, monkeypatch, capsys):
    js = jax_script("run_audio_test")
    rc_j, out_j = run_jax(js, [], monkeypatch, capsys)
    j = {n: read_wav(workdir / n) for n in ("test_output_v1.wav",
                                            "test_output_v2.wav")}
    rc_t, out_t = run_port(run_audio_test.main, ["--device", "cpu"], capsys)
    assert rc_j == rc_t == 0
    lj, lt = out_j.splitlines(), out_t.splitlines()
    assert lt[-2:] == lj[-2:] == [
        "wrote test_output_v1.wav / test_output_v2.wav", "PASS"]
    for k in (0, 1):
        tag = f"v{k + 1}: "
        assert lt[k].startswith(tag) and lj[k].startswith(tag)
        vals_t = [float(v) for v in re.findall(r"-?\d+\.\d+", lt[k])]
        vals_j = [float(v) for v in re.findall(r"-?\d+\.\d+", lj[k])]
        assert len(vals_t) == len(vals_j) == 2
        assert all(abs(a - b) <= LU_TOL for a, b in zip(vals_t, vals_j))
    for name, want in j.items():
        got = read_wav(workdir / name)
        assert got.shape == want.shape == (2, 8 * 44100)
        assert float(np.max(np.abs(got - want))) * 32768.0 <= LSB_TOL


def _last_digit_close(a: str, b: str) -> bool:
    """Two lines equal but for numbers, which differ by at most one unit
    of their last printed digit."""
    num = r"-?\d+\.\d+"
    if re.sub(num, "#", a) != re.sub(num, "#", b):
        return False
    for x, y in zip(re.findall(num, a), re.findall(num, b)):
        unit = 10.0 ** -len(x.split(".")[1])
        if abs(float(x) - float(y)) > unit * 1.0001:
            return False
    return True


def test_diagnose_file_matches_jax(workdir, monkeypatch, capsys):
    write_wav16(workdir / "in.wav", run_self_diagnosis.make_track())
    js = jax_script("run_diagnose_file")
    rc_j, out_j = run_jax(js, ["in.wav"], monkeypatch, capsys)
    rc_t, out_t = run_port(run_diagnose_file.main,
                           ["in.wav", "--device", "cpu"], capsys)
    assert rc_j == rc_t == 0
    lj, lt = out_j.splitlines(), out_t.splitlines()
    assert len(lt) == len(lj) >= 13
    stages = [ln for ln in lt if ln.startswith("  ") and "intro:" in ln]
    assert len(stages) >= 7 and "v2_output_fade_in" in stages[-1]
    for a, b in zip(lt, lj):
        assert _last_digit_close(a, b), (a, b)


def test_diagnose_file_usage(capsys):
    assert run_diagnose_file.main([]) == 2
    assert capsys.readouterr().out == "usage: run_diagnose_file.py file.wav\n"


@pytest.mark.parametrize("model", ["center_extract", "htdemucs"])
def test_isolate_vocal_matches_jax(model, workdir, monkeypatch, capsys):
    """Both models on a 3 s WAV: the JAX script on its bundled orbax
    checkpoint, the port's on its bundled ``.npz``."""
    from amw_tpu.models import vocal as jvocal
    from amw_tpu_torch.models import vocal as tvocal

    monkeypatch.delenv("AMW_HTDEMUCS_CKPT", raising=False)
    write_wav16(workdir / "in.wav", run_self_diagnosis.make_track(dur=3.0))
    extra_j, extra_t = [], []
    if model == "htdemucs":
        monkeypatch.setenv("AMW_HTDEMUCS_CKPT", "bundled")
        orbax = jvocal.htdemucs_checkpoint_path()
        assert orbax.endswith("htdemucs_tiny")
        extra_j = ["--model", "htdemucs", "--weights", orbax]
        extra_t = ["--model", "htdemucs", "--weights", tvocal.BUNDLED]
    js = jax_script("run_isolate_vocal")
    rc_j, out_j = run_jax(js, ["in.wav", "j.wav", *extra_j], monkeypatch,
                          capsys)
    rc_t, out_t = run_port(run_isolate_vocal.main,
                           ["in.wav", "t.wav", *extra_t, "--device", "cpu"],
                           capsys)
    assert rc_j == rc_t == 0
    assert (out_j, out_t) == ("wrote j.wav\n", "wrote t.wav\n")
    a, b = read_wav(workdir / "t.wav"), read_wav(workdir / "j.wav")
    assert a.shape == b.shape == (2, 3 * 44100)
    assert float(np.max(np.abs(a))) > 1e-3
    assert float(np.max(np.abs(a - b))) * 32768.0 <= LSB_TOL
    if model == "htdemucs":
        # the JAX script's pin stays: the port's main gave back the
        # setting it found
        assert os.environ["AMW_HTDEMUCS_CKPT"] == orbax
        # the network ran: not the DSP separator's output
        dsp = tvocal.isolate_vocal(read_wav(workdir / "in.wav"), 44100,
                                   model="center_extract", device="cpu")
        assert float(np.max(np.abs(a - dsp))) > 1e-3


def test_isolate_vocal_refuses_orbax(workdir, monkeypatch):
    from amw_tpu.models import vocal as jvocal

    monkeypatch.setenv("AMW_HTDEMUCS_CKPT", "bundled")
    orbax = jvocal.htdemucs_checkpoint_path()
    write_wav16(workdir / "in.wav", np.zeros((2, 44100), np.float32))
    with pytest.raises(ValueError, match="convert_htdemucs_port"):
        run_isolate_vocal.main(["in.wav", "o.wav", "--model", "htdemucs",
                                "--weights", orbax, "--device", "cpu"])


def _rows(text: str) -> dict:
    """``{group: [(method, path, description)]}`` of a reference."""
    out, group = {}, None
    for line in text.splitlines():
        if line.startswith("## "):
            group = line[3:]
            out[group] = []
        elif line.startswith("| ") and not line.startswith("| Method"):
            m = re.match(r"\| (\S+) \| `([^`]*)` \| (.*) \|$", line)
            out[group].append(m.groups())
    return out


def test_api_docs_match_jax(workdir, monkeypatch, capsys):
    """The JAX script writes next to its own file, so it runs from a copy
    in the temporary directory; the port's writes ``--out``."""
    repo_doc = (ROOT / "docs" / "API.md").read_bytes()
    (workdir / "scripts").mkdir()
    (workdir / "docs").mkdir()
    shutil.copy(ROOT / "scripts" / "gen_api_docs.py", workdir / "scripts")
    js = jax_script("gen_api_docs", workdir / "scripts" / "gen_api_docs.py")
    run_jax(js, [], monkeypatch, capsys)
    want = (workdir / "docs" / "API.md").read_text()
    rc, said = run_port(gen_api_docs.main,
                        ["--out", "api.md", "--device", "cpu"], capsys)
    got = (workdir / "api.md").read_text()
    assert rc == 0
    n = sum(len(v) for v in _rows(got).values())
    assert said == f"wrote api.md ({n} endpoints)\n" and n >= 150
    gl, wl = got.splitlines(), want.splitlines()
    assert len(gl) == len(wl)
    differ = [(a, b) for a, b in zip(gl, wl) if a != b]
    assert differ == [(
        "Generated from the route table by "
        "`amw_tpu_torch/scripts/gen_api_docs.py` — do not edit by hand.",
        "Generated from the route table by `scripts/gen_api_docs.py` — do "
        "not edit by hand.")]
    # the groups and their (method, path) rows are the JAX app's
    rows_g, rows_w = _rows(got), _rows(want)
    assert list(rows_g) == list(rows_w)
    for group in rows_w:
        assert [r[:2] for r in rows_g[group]] == \
            [r[:2] for r in rows_w[group]], group
    # stdout without --out: the same document
    rc, text = run_port(gen_api_docs.main, ["--device", "cpu"], capsys)
    assert rc == 0 and text == got
    assert (ROOT / "docs" / "API.md").read_bytes() == repo_doc
