"""The FFT planning switches, read at call time by both packages alike.

``AMW_FFT_PALLAS`` routes a plan through the staged FFT (the JAX package's
``fft_pallas.enabled``, the port's ``fft_staged.enabled``) and
``AMW_FFT_PREFER_PALLAS_MAX`` bounds how far a 3·2^k or 5·2^k size is
padded up to a staged power of two (``amw_tpu.ops.design.next_fft_size``,
the port's ``fft_staged.site_plan``).  The port's card takes the TPU's
place: ``site_plan(n, "cuda")`` is held against the JAX rule with
``fft_pallas.enabled`` answering as it does on a TPU, and
``site_plan(n, "cpu")`` against the JAX rule as it runs here, on the CPU.
"""

import numpy as np
import pytest

from amw_tpu.ops import design as jdesign
from amw_tpu.ops import fft_pallas as jfp
from amw_tpu_torch.ops import design as tdesign
from amw_tpu_torch.ops import fft_staged as tfs


def _lengths() -> list:
    """Track lengths either side of every 2^k, 3·2^k and 5·2^k size from
    2^18 to 2^25: they cross each choice between a 3·2^k or 5·2^k size and
    the next power of two."""
    sizes = sorted({m << k for m in (1, 3, 5) for k in range(15, 26)
                    if (1 << 18) <= m << k <= (1 << 25)})
    return sorted({n + d for n in sizes for d in (-1, 0, 1)})


def _old_default_plan(n: int) -> tuple:
    """The port's site plan on the card before the switches were read:
    the 1.75x preference, the staged FFT at every plan it takes."""
    best = tdesign.next_fft_size(n)
    pow2 = 1 << (n - 1).bit_length()
    if (best & (best - 1) and tfs.plan_ok(pow2) and not tfs.plan_ok(best)
            and pow2 <= 1.75 * best):
        return pow2, True
    return best, tfs.plan_ok(best)


@pytest.mark.parametrize("prefer", [None, "1.0", "1.3", "2.0"])
@pytest.mark.parametrize("pallas", [None, "0", "1"])
def test_site_plan_follows_the_jax_rule(monkeypatch, pallas, prefer):
    for name, value in (("AMW_FFT_PALLAS", pallas),
                        ("AMW_FFT_PREFER_PALLAS_MAX", prefer)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    plan_ok = jfp.plan_ok
    lengths = _lengths()
    # the JAX package on this machine's CPU backend
    cpu = [jdesign.next_fft_size(n) for n in lengths]

    def tpu_enabled(nfft):
        if pallas is not None:
            return plan_ok(nfft) and pallas == "1"
        return plan_ok(nfft)

    monkeypatch.setattr(jfp, "enabled", tpu_enabled)
    tpu = [jdesign.next_fft_size(n) for n in lengths]
    staged_seen = set()
    for n, want_cpu, want_tpu in zip(lengths, cpu, tpu):
        got = tfs.site_plan(n, "cuda")
        assert got == (want_tpu, tpu_enabled(want_tpu)), (n, got, want_tpu)
        assert tfs.enabled(want_tpu, "cuda") == tpu_enabled(want_tpu), n
        staged_seen.add(got[1])
        got = tfs.site_plan(n, "cpu")
        assert got == (want_cpu, pallas == "1" and plan_ok(want_cpu)), \
            (n, got, want_cpu)
        if pallas is None and prefer is None:
            assert tfs.site_plan(n, "cuda") == _old_default_plan(n), n
    # both routes occur on the card unless the flag turns the staged FFT off
    assert staged_seen == ({False} if pallas == "0" else {False, True})
    # the preference moved the plans: padded up to a power of two at the
    # default and at 2.0, never at 1.0 or 1.3 (3·2^k pads 4/3, 5·2^k 8/5)
    padded = [t != tdesign.next_fft_size(n) for n, t in zip(lengths, tpu)]
    assert any(padded) == (pallas != "0" and prefer in (None, "2.0"))
    assert np.all(np.asarray(tpu) >= np.asarray(lengths))
