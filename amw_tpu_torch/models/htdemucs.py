"""The hybrid-transformer Demucs (htdemucs) vocal separator in PyTorch
(counterpart of ``amw_tpu/models/htdemucs_jax.py``, with the module tree of
its CPU oracle ``amw_tpu/models/htdemucs_torch.py``).

The reference separates vocals with the ``demucs`` package's pretrained
``htdemucs`` (services/vocal_isolation.py:13-63): a waveform U-Net and a
spectrogram U-Net joined by a cross-domain transformer at the bottom.
:class:`HTDemucs` keeps the upstream state-dict names (``encoder.N.conv.*``,
``crosstransformer.layers.N.*``, ...), so ``load_state_dict`` takes the JAX
package's parameter dict key for key, and its forward computes what
``htdemucs_jax.forward`` computes:

- the complex-as-channels spectrogram of demucs' ``_spec``/``_ispec``
  (``torch.stft``'s framing, reflect padding and ``normalized=True``),
  on ``torch.fft``, the overlap-add divided by the window-square sum
  taken in float64 on the host;
- the normalisations with ``std`` at ddof 1; the frequency embedding at
  encoder 0; the channel up- and down-samplers; the transformer with its
  1-D and 2-D sin embeddings; the decoders; the de-normalisation in f32.

The network has no Pallas kernel in the JAX package (its convolutions,
matmuls and attention are XLA's), so it has no hand kernel here:
``F.conv*`` and ``torch.matmul`` stand where JAX has
``lax.conv_general_dilated`` and ``@``.

Inference dtype (``AMW_HTDEMUCS_DTYPE``, read at each call: ``auto``,
``f32`` or ``bf16``; ``auto`` is bf16 on ``cuda``, f32 on the CPU, as the
JAX package takes bf16 on its accelerator): in bf16 the weights are cast
once, when the module is built (:func:`inference_model`), and the
activations are bf16; the norms take f32 statistics with their weights
upcast, the attention scores and softmax are f32, and the STFT boundary
and the de-normalisation stay f32.  An f32 forward on the card runs its
convolutions and matmuls in full f32 (cuDNN takes TF32 for f32
convolutions by default): :func:`_full_f32` switches TF32 off around it,
under a lock, since the switches are global and the engine serves
requests in threads.

Weights: :func:`load_params` reads the port's own file, a ``.npz`` of
float32 arrays under the upstream names plus ``__config__`` (the config
vector of ``htdemucs_jax._config_vec``); ``scripts/convert_htdemucs_port.py``
writes it from the JAX package's orbax checkpoints.  :func:`separate`
runs a track's overlapping windows through the network and cross-fades
them (``htdemucs_jax.separate``); :func:`separate_mesh` splits the window
groups over the positions of a mesh (``parallel/mesh.py``), each running
its groups on its device, and sums the partial accumulators
(``htdemucs_jax.separate_mesh``).
"""

from __future__ import annotations

import functools
import math
import os
import warnings

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import resolve_device
from ..precision import full_f32 as _full_f32

SOURCES = ("drums", "bass", "other", "vocals")

_DTYPE_MODES = ("auto", "f32", "bf16")


def inference_dtype(device) -> torch.dtype:
    """The inference dtype on ``device`` under ``AMW_HTDEMUCS_DTYPE``
    (read at each call): ``bf16`` or ``f32`` as set; ``auto`` (the
    default, and what an invalid value falls back to) bf16 on ``cuda``,
    f32 elsewhere."""
    mode = os.environ.get("AMW_HTDEMUCS_DTYPE", "auto")
    if mode not in _DTYPE_MODES:
        warnings.warn(f"AMW_HTDEMUCS_DTYPE={mode!r} is not a valid mode "
                      "(valid: auto | f32 | bf16); falling back to 'auto'")
        mode = "auto"
    if mode == "auto":
        mode = "bf16" if torch.device(device).type == "cuda" else "f32"
    return torch.bfloat16 if mode == "bf16" else torch.float32


# --- config (a copy of htdemucs_jax.py:411-452, 581-657) ---------------------


class HTConfig:
    """Architecture hyperparameters of the released ``htdemucs`` model."""

    def __init__(self, sources=SOURCES, audio_channels=2, channels=48,
                 growth=2, depth=4, nfft=4096, bottom_channels=512,
                 t_layers=5, t_heads=8, t_hidden_scale=4.0,
                 dconv_depth=2, dconv_comp=8, dconv_init=1e-3,
                 freq_emb_scale=0.2, emb_scale=10.0, emb_smooth=True,
                 segment=7.8, samplerate=44100):
        self.sources = tuple(sources)
        self.audio_channels = audio_channels
        self.channels = channels
        self.growth = growth
        self.depth = depth
        self.nfft = nfft
        self.hop = nfft // 4
        self.bottom_channels = bottom_channels
        self.t_layers = t_layers
        self.t_heads = t_heads
        self.t_hidden_scale = t_hidden_scale
        self.dconv_depth = dconv_depth
        self.dconv_comp = dconv_comp
        self.dconv_init = dconv_init
        self.freq_emb_scale = freq_emb_scale
        self.emb_scale = emb_scale
        self.emb_smooth = emb_smooth
        self.segment = segment
        self.samplerate = samplerate

    @property
    def segment_samples(self):
        return int(self.segment * self.samplerate)


def tiny_config(**kw):
    """Small config for parity tests (same topology, ~1000x fewer FLOPs)."""
    base = dict(channels=8, nfft=1024, bottom_channels=24, t_layers=3,
                t_heads=2, depth=4, segment=1.0, samplerate=8000)
    base.update(kw)
    return HTConfig(**base)


_CONFIG_KEY = "__config__"
_CONFIG_FIELDS = ("channels", "nfft", "bottom_channels", "t_layers",
                  "t_heads", "depth", "samplerate")
_CONFIG_FLOAT_FIELDS = ("segment",)  # float64 vec holds ints + floats
# then the source count and audio_channels (older vecs are shorter and keep
# the 4-stem stereo defaults)


def _config_vec(cfg: HTConfig) -> np.ndarray:
    vals = [getattr(cfg, f) for f in _CONFIG_FIELDS]
    vals += [getattr(cfg, f) for f in _CONFIG_FLOAT_FIELDS]
    vals += [len(cfg.sources), cfg.audio_channels]
    return np.asarray(vals, np.float64)


def _default_source_names(n: int) -> tuple:
    if n <= len(SOURCES):
        return SOURCES[:n]
    return SOURCES + tuple(f"stem{i}" for i in range(len(SOURCES), n))


def _config_from_vec(v) -> HTConfig:
    v = np.asarray(v)
    vals = dict(zip(_CONFIG_FIELDS, (int(x) for x in v)))
    # Older checkpoints stored fewer fields; keep their defaults.
    base = len(_CONFIG_FIELDS)
    for i, f in enumerate(_CONFIG_FLOAT_FIELDS):
        if base + i < v.shape[0]:
            vals[f] = float(v[base + i])
    base += len(_CONFIG_FLOAT_FIELDS)
    if base + 1 < v.shape[0]:
        vals["sources"] = _default_source_names(int(v[base]))
        vals["audio_channels"] = int(v[base + 1])
    return HTConfig(**vals)


def config_from_kwargs(kwargs: dict) -> HTConfig:
    """HTConfig from the demucs package format's embedded model ``kwargs``
    ({'klass','args','kwargs','state'}), so that a non-default variant
    (e.g. 6-stem ``htdemucs_6s``) keeps its true shape."""
    accepted = {
        "sources", "audio_channels", "channels", "growth", "depth", "nfft",
        "bottom_channels", "t_layers", "t_heads", "t_hidden_scale",
        "dconv_depth", "dconv_comp", "dconv_init", "freq_emb_scale",
        "emb_scale", "emb_smooth", "segment", "samplerate",
    }
    # demucs names a few fields differently from our constructor.
    renames = {"t_hidden": "t_hidden_scale", "freq_emb": "freq_emb_scale",
               "emb_smooth": "emb_smooth"}
    kw = {}
    for k, val in dict(kwargs or {}).items():
        k = renames.get(k, k)
        if k in accepted and val is not None:
            kw[k] = tuple(val) if k == "sources" else val
    return HTConfig(**kw)


def check_params_shape(params: dict, cfg: HTConfig) -> None:
    """Raise ``ValueError`` where the tensors do not match the config's
    input/output shapes (a checkpoint stamped with the wrong variant)."""
    w = params.get("encoder.0.conv.weight")
    if w is not None:
        # Frequency-branch entry conv consumes CaC input: 2*audio_channels.
        want_in, want_out = 2 * cfg.audio_channels, cfg.channels
        got_out, got_in = int(w.shape[0]), int(w.shape[1])
        if (got_in, got_out) != (want_in, want_out):
            raise ValueError(
                f"encoder.0.conv.weight is [{got_out}, {got_in}, ...] but the "
                f"config implies [{want_out}, {want_in}, ...] "
                f"(audio_channels={cfg.audio_channels}, "
                f"channels={cfg.channels})")
    w = params.get(f"decoder.{cfg.depth - 1}.conv_tr.weight")
    if w is not None:
        want_out = len(cfg.sources) * cfg.audio_channels * 2  # CaC stems
        if int(w.shape[1]) != want_out:
            raise ValueError(
                f"final decoder emits {int(w.shape[1])} channels but the "
                f"config implies {want_out} ({len(cfg.sources)} sources "
                f"x {cfg.audio_channels} ch x CaC)")


# --- primitives (htdemucs_jax.py:85-186) -------------------------------------


def _group_norm1(x, norm: nn.GroupNorm):
    """GroupNorm(1) over channel-first [B, C, *]; f32 statistics and
    affine whatever the activation dtype."""
    return F.group_norm(x.float(), 1, norm.weight.float(), norm.bias.float(),
                        norm.eps).to(x.dtype)


def _layer_norm(x, norm: nn.LayerNorm):
    """LayerNorm over the last axis; f32 statistics."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(),
                        norm.bias.float(), norm.eps).to(x.dtype)


def _group_norm_tokens(x, norm: nn.GroupNorm):
    """demucs MyGroupNorm(1, C) on channel-last tokens [B, T, C]: over C
    and T jointly; f32 statistics."""
    x32 = x.float()
    var, mu = torch.var_mean(x32, dim=(1, 2), keepdim=True, correction=0)
    y = (x32 - mu) / torch.sqrt(var + norm.eps) * norm.weight.float() \
        + norm.bias.float()
    return y.to(x.dtype)


def _mha(q_in, kv_in, attn: nn.MultiheadAttention, heads: int):
    """``nn.MultiheadAttention`` (batch first, no mask) as matmul, f32
    softmax, matmul; the scores are taken in f32 from the activation-dtype
    product, as ``htdemucs_jax.mha``.  q_in: [B, Tq, D]."""
    D = q_in.shape[-1]
    w, b = attn.in_proj_weight, attn.in_proj_bias
    if kv_in is q_in:
        q, k, v = F.linear(q_in, w, b).chunk(3, dim=-1)
    else:
        q = F.linear(q_in, w[:D], b[:D])
        k, v = F.linear(kv_in, w[D:], b[D:]).chunk(2, dim=-1)
    B, Tq, _ = q.shape
    Tk = k.shape[1]
    hd = D // heads
    q = q.reshape(B, Tq, heads, hd).transpose(1, 2)
    k = k.reshape(B, Tk, heads, hd).transpose(1, 2)
    v = v.reshape(B, Tk, heads, hd).transpose(1, 2)
    scores = torch.matmul(q, k.transpose(-1, -2)).float() / math.sqrt(hd)
    att = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.matmul(att, v).transpose(1, 2).reshape(B, Tq, D)
    return F.linear(out, attn.out_proj.weight, attn.out_proj.bias)


# --- STFT / iSTFT (torch.stft/istft + demucs _spec/_ispec) -------------------


def _hann(n: int) -> np.ndarray:
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(
        np.float32)


def _constant(fn):
    """An ``lru_cache`` of host-built constant tensors, each made outside
    inference mode: a tensor first made under ``torch.inference_mode`` (a
    served forward) could not be saved for the backward of a later
    training step."""
    @functools.lru_cache(maxsize=32)
    @functools.wraps(fn)
    def cached(*args):
        with torch.inference_mode(False):
            return fn(*args)
    return cached


@_constant
def _window(nfft: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_hann(nfft)).to(device)


@_constant
def _ola_norm(nfft: int, hop: int, frames: int,
              device: torch.device) -> torch.Tensor:
    """1 / the window-square overlap-add of ``frames`` frames, summed in
    float64 on the host (1 where it vanishes)."""
    norm = np.zeros((frames - 1) * hop + nfft, np.float64)
    w2 = _hann(nfft).astype(np.float64) ** 2
    for f in range(frames):
        norm[f * hop:f * hop + nfft] += w2
    return torch.from_numpy(
        np.where(norm > 1e-11, norm, 1.0).astype(np.float32)).to(device)


def _stft(x, nfft: int, hop: int):
    """torch.stft(center=True, pad_mode='reflect', normalized=True,
    onesided) of f32 ``x`` [..., T] -> (re, im), each [..., F, frames]."""
    lead, n = x.shape[:-1], x.shape[-1]
    pad = nfft // 2
    xp = F.pad(x.reshape(-1, 1, n), (pad, pad), mode="reflect")[:, 0]
    fr = xp.unfold(-1, nfft, hop) * _window(nfft, x.device)
    z = torch.fft.rfft(fr, dim=-1) * (nfft ** -0.5)   # [N, frames, F]
    frames, n_freq = z.shape[-2:]
    z = z.transpose(-1, -2).reshape(lead + (n_freq, frames))
    return z.real, z.imag


def _istft(re, im, nfft: int, hop: int, length: int):
    """torch.istft(center=True, normalized=True, length=length) of
    [..., F, frames] -> [..., length]: irfft, window, overlap-add as
    ``nfft // hop`` shifted adds over the hop-strided frames.  The
    imaginary parts of the DC and Nyquist bins are dropped, as the CPU's
    (and XLA's) inverse real FFT drops them; cuFFT's would fold them in
    (the network's output has a nonzero one at DC)."""
    im = F.pad(im[..., 1:-1, :], (0, 0, 1, 1))
    z = torch.complex(re.transpose(-1, -2), im.transpose(-1, -2))
    fr = torch.fft.irfft(z, n=nfft, dim=-1) * (nfft ** 0.5)
    fr = fr * _window(nfft, fr.device)
    frames = fr.shape[-2]
    lead = fr.shape[:-2]
    R = nfft // hop
    frv = fr.reshape(lead + (frames, R, hop))
    acc = fr.new_zeros(lead + (frames + R - 1, hop))
    for k in range(R):
        acc[..., k:k + frames, :] += frv[..., :, k, :]
    out = acc.reshape(lead + ((frames + R - 1) * hop,))
    out = out / _ola_norm(nfft, hop, frames, out.device)
    pad = nfft // 2
    return out[..., pad:pad + length]


def _spec(x, nfft: int, hop: int):
    """demucs HDemucs._spec: extra reflect pad + frame crop; drops the
    Nyquist row.  x [B, C, T] f32 -> (re, im) [B, C, nfft/2, ceil(T/hop)]."""
    le = int(math.ceil(x.shape[-1] / hop))
    pad = hop // 2 * 3
    extra = pad + le * hop - x.shape[-1]
    xp = F.pad(x, (pad, extra), mode="reflect")
    re, im = _stft(xp, nfft, hop)
    return re[..., :-1, 2:2 + le], im[..., :-1, 2:2 + le]


def _ispec(re, im, hop: int, length: int):
    """demucs HDemucs._ispec (restores the Nyquist row and 2 frames)."""
    re = F.pad(re, (2, 2, 0, 1))
    im = F.pad(im, (2, 2, 0, 1))
    nfft = 2 * (re.shape[-2] - 1)
    pad = hop // 2 * 3
    le = hop * int(math.ceil(length / hop)) + 2 * pad
    x = _istft(re, im, nfft, hop, le)
    return x[..., pad:pad + length]


@_constant
def _sin_embedding_1d(length: int, dim: int, device: torch.device,
                      dtype: torch.dtype, max_period: float = 10000.0):
    """[1, T, C] (htdemucs_jax._sin_embedding_1d, float64 on the host)."""
    pos = np.arange(length)[:, None].astype(np.float64)
    adim = np.arange(dim // 2)[None, :].astype(np.float64)
    phase = pos / (max_period ** (adim / (dim // 2 - 1)))
    emb = np.concatenate([np.cos(phase), np.sin(phase)],
                         axis=-1).astype(np.float32)
    return torch.from_numpy(emb)[None].to(device=device, dtype=dtype)


@_constant
def _sin_embedding_2d(d_model: int, height: int, width: int,
                      device: torch.device, dtype: torch.dtype,
                      max_period: float = 10000.0):
    """The 2-D embedding as tokens [1, W * H, C] in the transformer's
    (time-major) order (htdemucs_jax._sin_embedding_2d)."""
    pe = np.zeros((d_model, height, width), np.float64)
    half = d_model // 2
    div_term = np.exp(np.arange(0.0, half, 2)
                      * -(math.log(max_period) / half))
    pos_w = np.arange(0.0, width)[:, None]
    pos_h = np.arange(0.0, height)[:, None]
    sw = np.sin(pos_w * div_term).T[:, None, :]       # [half/2, 1, W]
    cw = np.cos(pos_w * div_term).T[:, None, :]
    sh = np.sin(pos_h * div_term).T[:, :, None]       # [half/2, H, 1]
    ch = np.cos(pos_h * div_term).T[:, :, None]
    pe[0:half:2] = np.repeat(sw, height, axis=1)
    pe[1:half:2] = np.repeat(cw, height, axis=1)
    pe[half::2] = np.repeat(sh, width, axis=2)
    pe[half + 1::2] = np.repeat(ch, width, axis=2)
    tok = pe.astype(np.float32).transpose(2, 1, 0).reshape(
        1, width * height, d_model)
    return torch.from_numpy(np.ascontiguousarray(tok)).to(device=device,
                                                          dtype=dtype)


# --- the module tree (names of demucs.htdemucs; htdemucs_torch.py:43-470) ----
# The constructors are the oracle's, in its order, so that a seeded build
# draws the same initial weights (init_params).  The forwards are this
# module's, with the dtype rules above.


class LayerScale(nn.Module):
    """A learned per-channel scale (parameter 'scale', as upstream)."""

    def __init__(self, channels, init=0.0):
        super().__init__()
        self.scale = nn.Parameter(torch.full((channels,), float(init)))


class DConv(nn.Module):
    """Residual dilated-conv branch (demucs.demucs.DConv, gelu, norm=True,
    no attn/lstm)."""

    def __init__(self, channels, compress=8, depth=2, init=1e-3, kernel=3):
        super().__init__()
        hidden = channels // compress
        self.layers = nn.ModuleList()
        for d in range(depth):
            dilation = 2 ** d
            padding = dilation * (kernel // 2)
            mods = [
                nn.Conv1d(channels, hidden, kernel, dilation=dilation,
                          padding=padding),
                nn.GroupNorm(1, hidden),
                nn.GELU(),
                nn.Conv1d(hidden, 2 * channels, 1),
                nn.GroupNorm(1, 2 * channels),
                nn.GLU(1),
                LayerScale(channels, init),
            ]
            self.layers.append(nn.Sequential(*mods))

    def forward(self, x):
        for layer in self.layers:
            conv1, gn1, _, conv2, gn2, _, scale = layer
            y = F.gelu(_group_norm1(conv1(x), gn1))
            y = F.glu(_group_norm1(conv2(y), gn2), dim=1)
            x = x + y * scale.scale[:, None]
        return x


class HEncLayer(nn.Module):
    """demucs.hdemucs.HEncLayer with norm=False, context=0 (1x1 rewrite),
    dconv=True."""

    def __init__(self, chin, chout, kernel_size=8, stride=4, freq=True,
                 dconv_kw=None):
        super().__init__()
        self.freq = freq
        self.stride = stride
        pad = kernel_size // 4
        if freq:
            self.conv = nn.Conv2d(chin, chout, (kernel_size, 1), (stride, 1),
                                  (pad, 0))
            self.rewrite = nn.Conv2d(chout, 2 * chout, 1, 1, 0)
        else:
            self.conv = nn.Conv1d(chin, chout, kernel_size, stride, pad)
            self.rewrite = nn.Conv1d(chout, 2 * chout, 1, 1, 0)
        self.dconv = DConv(chout, **(dconv_kw or {}))

    def forward(self, x):
        if not self.freq:
            le = x.shape[-1]
            if le % self.stride != 0:
                x = F.pad(x, (0, self.stride - le % self.stride))
        y = F.gelu(self.conv(x))
        if self.freq:
            B, C, Fr, T = y.shape
            y = y.permute(0, 2, 1, 3).reshape(B * Fr, C, T)
            y = self.dconv(y)
            y = y.reshape(B, Fr, C, T).permute(0, 2, 1, 3)
        else:
            y = self.dconv(y)
        return F.glu(self.rewrite(y), dim=1)


class HDecLayer(nn.Module):
    """demucs.hdemucs.HDecLayer with norm=False, context=1 (3x3 / k3
    rewrite), dconv=False."""

    def __init__(self, chin, chout, last=False, kernel_size=8, stride=4,
                 freq=True):
        super().__init__()
        self.freq = freq
        self.last = last
        self.pad = kernel_size // 4
        if freq:
            self.conv_tr = nn.ConvTranspose2d(chin, chout, (kernel_size, 1),
                                              (stride, 1))
            self.rewrite = nn.Conv2d(chin, 2 * chin, 3, 1, 1)
        else:
            self.conv_tr = nn.ConvTranspose1d(chin, chout, kernel_size,
                                              stride)
            self.rewrite = nn.Conv1d(chin, 2 * chin, 3, 1, 1)

    def forward(self, x, skip, length):
        y = F.glu(self.rewrite(x + skip), dim=1)
        z = self.conv_tr(y)
        if self.freq:
            z = z[..., self.pad:-self.pad, :]
        else:
            z = z[..., self.pad:self.pad + length]
        return z if self.last else F.gelu(z)


class ScaledEmbedding(nn.Module):
    """demucs.hdemucs.ScaledEmbedding (smooth cumsum init, /scale storage)."""

    def __init__(self, num_embeddings, embedding_dim, scale=10.0,
                 smooth=True):
        super().__init__()
        self.embedding = nn.Embedding(num_embeddings, embedding_dim)
        if smooth:
            weight = torch.cumsum(self.embedding.weight.data, dim=0)
            weight = weight / torch.arange(
                1, num_embeddings + 1).to(weight).sqrt()[:, None]
            self.embedding.weight.data[:] = weight
        self.embedding.weight.data /= scale


class MyTransformerEncoderLayer(nn.Module):
    """Pre-norm self-attention layer with LayerScale and a GroupNorm output
    (t_layer_scale=True, t_norm_out=True, gelu)."""

    def __init__(self, d_model, nhead, dim_feedforward,
                 layer_scale_init=1e-4):
        super().__init__()
        self.nhead = nhead
        self.self_attn = nn.MultiheadAttention(d_model, nhead,
                                               batch_first=True)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model)
        self.norm2 = nn.LayerNorm(d_model)
        self.norm_out = nn.GroupNorm(1, d_model)  # demucs MyGroupNorm
        self.gamma_1 = LayerScale(d_model, layer_scale_init)
        self.gamma_2 = LayerScale(d_model, layer_scale_init)

    def forward(self, x):
        h = _layer_norm(x, self.norm1)
        x = x + _mha(h, h, self.self_attn, self.nhead) * self.gamma_1.scale
        return _feed_forward(self, x, _layer_norm(x, self.norm2))


class CrossTransformerEncoderLayer(nn.Module):
    """Pre-norm cross-attention layer (q attends to the other domain)."""

    def __init__(self, d_model, nhead, dim_feedforward,
                 layer_scale_init=1e-4):
        super().__init__()
        self.nhead = nhead
        self.cross_attn = nn.MultiheadAttention(d_model, nhead,
                                                batch_first=True)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model)
        self.norm2 = nn.LayerNorm(d_model)
        self.norm3 = nn.LayerNorm(d_model)
        self.norm_out = nn.GroupNorm(1, d_model)  # demucs MyGroupNorm
        self.gamma_1 = LayerScale(d_model, layer_scale_init)
        self.gamma_2 = LayerScale(d_model, layer_scale_init)

    def forward(self, x, kv):
        h = _mha(_layer_norm(x, self.norm1), _layer_norm(kv, self.norm2),
                 self.cross_attn, self.nhead)
        x = x + h * self.gamma_1.scale
        return _feed_forward(self, x, _layer_norm(x, self.norm3))


def _feed_forward(layer, x, h):
    """The second half of both layer kinds: linear, gelu, linear, scaled
    residual, token GroupNorm."""
    h = layer.linear2(F.gelu(layer.linear1(h)))
    return _group_norm_tokens(x + h * layer.gamma_2.scale, layer.norm_out)


class CrossTransformerEncoder(nn.Module):
    """Alternating self/cross layers over the two domains (cross_first=False:
    even layers self, odd layers cross)."""

    def __init__(self, dim, heads, num_layers, hidden_scale=4.0):
        super().__init__()
        self.num_layers = num_layers
        hidden = int(dim * hidden_scale)
        self.norm_in = nn.LayerNorm(dim)
        self.norm_in_t = nn.LayerNorm(dim)
        self.layers = nn.ModuleList()
        self.layers_t = nn.ModuleList()
        for i in range(num_layers):
            kind = (MyTransformerEncoderLayer if i % 2 == 0
                    else CrossTransformerEncoderLayer)
            self.layers.append(kind(dim, heads, hidden))
            self.layers_t.append(kind(dim, heads, hidden))

    def forward(self, x, xt):
        B, C, Fr, T1 = x.shape
        x = x.permute(0, 3, 2, 1).reshape(B, T1 * Fr, C)
        x = _layer_norm(x, self.norm_in) + _sin_embedding_2d(
            C, Fr, T1, x.device, x.dtype)
        T2 = xt.shape[-1]
        xt = xt.permute(0, 2, 1)
        xt = _layer_norm(xt, self.norm_in_t) + _sin_embedding_1d(
            T2, C, xt.device, xt.dtype)
        for i in range(self.num_layers):
            if i % 2 == 0:
                x = self.layers[i](x)
                xt = self.layers_t[i](xt)
            else:
                old_x = x
                x = self.layers[i](x, xt)
                xt = self.layers_t[i](xt, old_x)
        x = x.reshape(B, T1, Fr, C).permute(0, 3, 2, 1)
        return x, xt.permute(0, 2, 1)


class HTDemucs(nn.Module):
    """The htdemucs network: ``forward(mix [B, C, T]) -> [B, S, C, T]``
    (``htdemucs_jax.forward``).  The activations take the dtype of the
    parameters (see :func:`inference_model`)."""

    def __init__(self, cfg: HTConfig | None = None):
        super().__init__()
        cfg = cfg or HTConfig()
        self.cfg = cfg
        S = len(cfg.sources)
        C = cfg.audio_channels
        dconv_kw = dict(compress=cfg.dconv_comp, depth=cfg.dconv_depth,
                        init=cfg.dconv_init)

        self.encoder = nn.ModuleList()
        self.tencoder = nn.ModuleList()
        self.decoder = nn.ModuleList()
        self.tdecoder = nn.ModuleList()
        chin, chin_z, chout = C, 2 * C, cfg.channels
        for index in range(cfg.depth):
            self.encoder.append(
                HEncLayer(chin_z, chout, freq=True, dconv_kw=dconv_kw))
            self.tencoder.append(
                HEncLayer(chin, chout, freq=False, dconv_kw=dconv_kw))
            self.decoder.insert(0, HDecLayer(
                chout, chin_z if index else S * 2 * C, last=index == 0,
                freq=True))
            self.tdecoder.insert(0, HDecLayer(
                chout, chin if index else S * C, last=index == 0, freq=False))
            chin, chin_z = chout, chout
            chout *= cfg.growth

        freqs_after_first = (cfg.nfft // 2) // 4
        self.freq_emb = ScaledEmbedding(freqs_after_first, cfg.channels,
                                        scale=cfg.emb_scale,
                                        smooth=cfg.emb_smooth)

        bottom = chin  # channels at the bottleneck
        bc = cfg.bottom_channels
        self.channel_upsampler = nn.Conv1d(bottom, bc, 1)
        self.channel_downsampler = nn.Conv1d(bc, bottom, 1)
        self.channel_upsampler_t = nn.Conv1d(bottom, bc, 1)
        self.channel_downsampler_t = nn.Conv1d(bc, bottom, 1)
        self.crosstransformer = CrossTransformerEncoder(
            bc, cfg.t_heads, cfg.t_layers, cfg.t_hidden_scale)

    def forward(self, mix):
        cfg = self.cfg
        S = len(cfg.sources)
        B, C, length = mix.shape
        mix = mix.float()

        re, im = _spec(mix, cfg.nfft, cfg.hop)             # [B, C, F, T]
        Fq, T = re.shape[-2], re.shape[-1]
        x = torch.stack([re, im], dim=2).reshape(B, 2 * C, Fq, T)  # CaC
        mean = x.mean(dim=(1, 2, 3), keepdim=True)
        std = x.std(dim=(1, 2, 3), keepdim=True)           # ddof 1
        x = (x - mean) / (1e-5 + std)

        xt = mix
        meant = xt.mean(dim=(1, 2), keepdim=True)
        stdt = xt.std(dim=(1, 2), keepdim=True)
        xt = (xt - meant) / (1e-5 + stdt)

        # the U-Net runs in the parameters' dtype; the statistics above and
        # the de-normalisation below stay f32 (bf16 * f32 promotes)
        act = self.freq_emb.embedding.weight.dtype
        x = x.to(act)
        xt = xt.to(act)

        saved, saved_t, lengths, lengths_t = [], [], [], []
        for idx in range(cfg.depth):
            lengths.append(x.shape[-1])
            lengths_t.append(xt.shape[-1])
            xt = self.tencoder[idx](xt)
            saved_t.append(xt)
            x = self.encoder[idx](x)
            if idx == 0:
                emb = (self.freq_emb.embedding.weight * cfg.emb_scale).t()
                x = x + cfg.freq_emb_scale * emb[None, :, :, None]
            saved.append(x)

        b, c, f, t = x.shape
        x = self.channel_upsampler(x.reshape(b, c, f * t))
        x = x.reshape(b, -1, f, t)
        xt = self.channel_upsampler_t(xt)
        x, xt = self.crosstransformer(x, xt)
        x = self.channel_downsampler(x.reshape(b, -1, f * t))
        x = x.reshape(b, c, f, t)
        xt = self.channel_downsampler_t(xt)

        for idx in range(cfg.depth):
            x = self.decoder[idx](x, saved.pop(-1), lengths.pop(-1))
            xt = self.tdecoder[idx](xt, saved_t.pop(-1), lengths_t.pop(-1))

        Fq2, T2 = x.shape[-2], x.shape[-1]
        x = x.reshape(B, S, 2 * C, Fq2, T2) * std[:, None] + mean[:, None]
        x = x.reshape(B, S, C, 2, Fq2, T2)
        xf = _ispec(x[:, :, :, 0], x[:, :, :, 1], cfg.hop, length)
        xt = xt.reshape(B, S, C, length) * stdt[:, None] + meant[:, None]
        return xt + xf


def forward(model: HTDemucs, mix) -> torch.Tensor:
    """One forward of ``mix`` [B, C, T] (numpy or tensor) on the model's
    device, under inference mode and the precision of the model's dtype
    (:func:`_full_f32`): stems [B, S, C, T], float32, on that device
    (``htdemucs_jax.forward``)."""
    p = next(model.parameters())
    with torch.inference_mode(), _full_f32(p.dtype):
        return model(torch.as_tensor(mix).to(p.device))


# --- weights ----------------------------------------------------------------


def init_params(cfg: HTConfig | None = None, seed: int = 0) -> dict:
    """A seeded random state dict (float32, CPU): the module built under
    ``torch.manual_seed(seed)`` in a forked RNG, which draws what
    ``htdemucs_jax.init_params`` draws for the same seed."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = HTDemucs(cfg or HTConfig())
    return {k: v.detach() for k, v in model.state_dict().items()}


def _build(cfg: HTConfig, state: dict) -> HTDemucs:
    """The module on the CPU holding ``state``'s tensors (no random init:
    built on the meta device, then the tensors assigned).  Raises
    ``ValueError`` where names or shapes differ from ``cfg``'s tree."""
    with torch.device("meta"):
        model = HTDemucs(cfg)
    try:
        model.load_state_dict(state, strict=True, assign=True)
    except RuntimeError as e:
        raise ValueError(f"htdemucs state does not match its config: {e}") \
            from None
    return model


def inference_model(cfg: HTConfig, state: dict, *, device,
                    dtype: torch.dtype | None = None) -> HTDemucs:
    """The network on ``device`` for inference (``None``: ``cuda``), its
    weights cast once to ``dtype`` (default :func:`inference_dtype`): the
    counterpart of ``htdemucs_jax.inference_params`` + ``device_put``.
    Frozen and in eval mode."""
    dev = resolve_device(device)
    dtype = dtype or inference_dtype(dev)
    model = _build(cfg, {k: torch.as_tensor(v) for k, v in state.items()})
    model = model.to(device=dev, dtype=dtype).eval()
    model.requires_grad_(False)
    return model


def train_model(cfg: HTConfig, state: dict, *, device) -> HTDemucs:
    """The network on ``device`` for training (``None``: ``cuda``): f32
    copies of ``state``'s tensors (the JAX package's parameter dict is
    taken key for key, as :func:`inference_model` takes it), gradients
    on, in train mode.  Run its steps under ``_full_f32(torch.float32)``
    (TF32 off), as the JAX trainer trains in f32."""
    dev = resolve_device(device)
    model = _build(cfg, {k: torch.as_tensor(v, dtype=torch.float32)
                         .detach().clone() for k, v in state.items()})
    return model.to(dev).train()


def load_params(path: str):
    """``(cfg, state)`` from the port's checkpoint file: a ``.npz`` of
    float32 arrays under the upstream names plus ``__config__``
    (:func:`_config_vec`; the released shape where it is missing).  The
    names are checked against the config's module tree when the module is
    built (:func:`inference_model` raises ``ValueError``)."""
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    vec = arrays.pop(_CONFIG_KEY, None)
    cfg = HTConfig() if vec is None else _config_from_vec(vec)
    check_params_shape(arrays, cfg)
    state = {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
             for k, v in arrays.items()}
    return cfg, state


def save_params(state: dict, path: str, cfg: HTConfig | None = None) -> None:
    """Write ``state`` (arrays or tensors) and ``cfg``'s vector to ``path``
    in :func:`load_params`' format."""
    blob = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)).astype(np.float32)
            for k, v in state.items()}
    blob[_CONFIG_KEY] = _config_vec(cfg or HTConfig())
    with open(path, "wb") as f:
        np.savez(f, **blob)


# --- overlap-add separation (htdemucs_jax.py:707-974) -----------------------


def oa_plan(cfg: HTConfig, T: int, segment: int | None = None,
            overlap: float = 0.25, batch: int = 4):
    """Overlap-add geometry for a T-sample track: (seg, stride, starts,
    nb_b, t_ext, span), as ``htdemucs_jax.oa_plan``.  ``nb_b``, the
    power-of-two bucket of window groups that keys the JAX package's
    executables, keys the engine's warmup here (no executable is built per
    bucket: every group runs the same forward)."""
    seg = segment or cfg.segment_samples
    stride = max(1, int(seg * (1 - overlap)))
    starts = list(range(0, max(T - seg, 0) + stride, stride))
    nb = (len(starts) + batch - 1) // batch
    nb_b = 1 << max(nb - 1, 0).bit_length()
    span = (batch - 1) * stride + seg
    t_ext = (nb_b - 1) * batch * stride + span
    return seg, stride, starts, nb_b, t_ext, span


def _pack_mix(mix: np.ndarray, t_ext: int) -> np.ndarray:
    """The mix padded to ``t_ext`` for the upload: int16 where every
    sample is exactly i/32768 (16-bit PCM sources: half the bytes,
    dequantised on the device bit for bit), else float32."""
    mixf = np.ascontiguousarray(mix, dtype=np.float32)
    T = mixf.shape[-1]
    xi = np.round(mixf * 32768.0)
    if (np.abs(xi).max(initial=0.0) <= 32767.0
            and np.array_equal(xi.astype(np.float32) / np.float32(32768.0),
                               mixf)):
        return np.pad(xi.astype(np.int16), ((0, 0), (0, t_ext - T)))
    return np.pad(mixf, ((0, 0), (0, t_ext - T)))


def _upload(host: np.ndarray, device) -> torch.Tensor:
    x = torch.from_numpy(np.ascontiguousarray(host)).to(device)
    return x.float() / 32768.0 if x.dtype == torch.int16 else x


def _fade(seg: int) -> np.ndarray:
    """The triangular cross-fade weight of a window (transition_power 1)."""
    w = np.concatenate([np.arange(1, seg // 2 + 1),
                        np.arange(seg - seg // 2, 0, -1)]).astype(np.float32)
    return w / w.max()


def separate(params, mix: np.ndarray, cfg: HTConfig | None = None,
             segment: int | None = None, overlap: float = 0.25,
             batch: int = 4, stems: tuple | None = None,
             host_oa: bool = False, *, device=None) -> np.ndarray:
    """[C, T] numpy -> stems [S, C, T] (``stems``: the names kept, picked
    on the device before the copy back): overlapping ``segment``-sample
    windows, ``batch`` a forward, cross-faded with triangular weights
    (``htdemucs_jax.separate``).

    ``params``: an :class:`HTDemucs` (its device; ``device``, if given,
    must be the same) or a state dict, built on ``device`` (default
    ``cuda``) for this call.  The mix is uploaded once (int16 where it is
    on the 16-bit grid, :func:`_pack_mix`); every window group slices it
    on the device, runs its valid windows (the padding of the last group
    is not run) and adds its weighted stems into one accumulator.
    The JAX package's ``stream`` route (``AMW_HTDEMUCS_STREAM``: one slab
    upload a window group, for double buffering) has no counterpart: the
    whole mix is tens of MB on an 80 GB card.  ``host_oa=True`` is the
    host-accumulation oracle: fixed-size batches padded with zeros, the
    sums in numpy."""
    if isinstance(params, HTDemucs):
        model = params
        dev = next(model.parameters()).device
        want = dev if device is None else torch.device(device)
        if want.type != dev.type or want.index not in (None, dev.index):
            raise ValueError(f"the model lies on {dev}, not on {device}")
    else:
        model = inference_model(cfg or HTConfig(), params, device=device)
        dev = next(model.parameters()).device
    cfg = model.cfg
    dtype = next(model.parameters()).dtype
    C, T = mix.shape
    seg, stride, starts, nb_b, t_ext, span = oa_plan(
        cfg, T, segment=segment, overlap=overlap, batch=batch)
    src_idx = (list(range(len(cfg.sources))) if stems is None
               else [cfg.sources.index(s) for s in stems])
    w = _fade(seg)
    n_seg = len(starts)
    nb = (n_seg + batch - 1) // batch
    with torch.inference_mode(), _full_f32(dtype):
        if host_oa:
            out = np.zeros((len(src_idx), C, T), np.float32)
            weight_acc = np.zeros(T, np.float32)
            for i in range(0, n_seg, batch):
                group = starts[i:i + batch]
                chunk = np.zeros((batch, C, seg), np.float32)
                for j, start in enumerate(group):
                    end = min(start + seg, T)
                    chunk[j, :, :end - start] = mix[:, start:end]
                st = model(torch.from_numpy(chunk).to(dev))
                st = st[:len(group), src_idx].float().cpu().numpy()
                for j, start in enumerate(group):
                    end = min(start + seg, T)
                    out[:, :, start:end] += st[j][:, :, :end - start] \
                        * w[:end - start]
                    weight_acc[start:end] += w[:end - start]
            return out / np.maximum(weight_acc, 1e-8)
        adv = batch * stride
        mix_dev = _upload(_pack_mix(mix, t_ext), dev)
        idx = torch.tensor(src_idx, device=dev)
        w_dev = torch.from_numpy(w).to(dev)
        out = torch.zeros((len(src_idx), C, t_ext), dtype=torch.float32,
                          device=dev)
        w_acc = torch.zeros(t_ext, dtype=torch.float32, device=dev)
        for i in range(nb):
            n_valid = min(batch, n_seg - i * batch)
            w0 = i * adv
            slab = mix_dev[:, w0:w0 + span]
            chunk = torch.stack([slab[:, j * stride:j * stride + seg]
                                 for j in range(n_valid)])
            st = model(chunk).index_select(1, idx)    # [n, n_sel, C, seg]
            for j in range(n_valid):
                s = w0 + j * stride
                out[:, :, s:s + seg] += st[j] * w_dev
                w_acc[s:s + seg] += w_dev
        out = (out / torch.clamp(w_acc, min=1e-8))[:, :, :T]
        return out.cpu().numpy()


def mesh_models(params, mesh, cfg: HTConfig | None = None) -> dict:
    """One inference model per distinct device of ``mesh``, by device, from
    ``params``: an :class:`HTDemucs` (taken as it is on its own device,
    copied to the others), a state dict (built on each device in the
    inference dtype), or such a dict by device already."""
    devs = mesh.distinct_devices()
    if isinstance(params, dict) and all(
            isinstance(k, torch.device) for k in params):
        missing = [d for d in devs if d not in params]
        if missing:
            raise ValueError(f"no model on {missing}")
        return params
    if isinstance(params, HTDemucs):
        import copy

        home = next(params.parameters()).device
        return {d: params if d == home else copy.deepcopy(params).to(d)
                for d in devs}
    return {d: inference_model(cfg or HTConfig(), params, device=d)
            for d in devs}


def separate_mesh(params, mix: np.ndarray, mesh, cfg: HTConfig | None = None,
                  axis: str = "dp", segment: int | None = None,
                  overlap: float = 0.25, batch: int = 4,
                  stems: tuple | None = None, device_out: bool = False):
    """Mesh-sharded separation (``htdemucs_jax.separate_mesh``): the
    overlap-add window groups are independent, so they split over the
    positions of the mesh's ``axis`` (the window-group count rounded up to
    a multiple of the positions; the extra groups hold no window and are
    not run).  Each position uploads the mix to its device, runs its
    contiguous block of groups there as :func:`separate` runs them, and
    adds their weighted stems into its own accumulators; the partial
    stem and weight accumulators are then summed over the positions (the
    JAX package's one ``psum``) and divided.  Other mesh axes are not
    used (the 2-D serving mesh shards over ``dp`` only).

    ``params``: as :func:`mesh_models` takes them.  Returns stems
    [S, C, T] as numpy, or with ``device_out`` as a tensor on the first
    position's device."""
    from ..parallel.mesh import axis_devices

    models = mesh_models(params, mesh, cfg)
    devs = axis_devices(mesh, axis)
    D = len(devs)
    cfg = next(iter(models.values())).cfg
    C, T = mix.shape
    seg, stride, starts, nb_b, _t_ext, span = oa_plan(
        cfg, T, segment=segment, overlap=overlap, batch=batch)
    nb_b2 = ((max(nb_b, D) + D - 1) // D) * D
    t_ext2 = (nb_b2 - 1) * batch * stride + span
    src_idx = (list(range(len(cfg.sources))) if stems is None
               else [cfg.sources.index(s) for s in stems])
    w = _fade(seg)
    n_seg = len(starts)
    nb = (n_seg + batch - 1) // batch
    local_nb = nb_b2 // D
    adv = batch * stride
    mix_host = _pack_mix(mix, t_ext2)
    uploads: dict = {}
    outs, wss = [], []
    for k, dev in enumerate(devs):
        model = models[dev]
        dtype = next(model.parameters()).dtype
        with torch.inference_mode(), _full_f32(dtype):
            if dev not in uploads:
                uploads[dev] = _upload(mix_host, dev)
            mix_dev = uploads[dev]
            idx = torch.tensor(src_idx, device=dev)
            w_dev = torch.from_numpy(w).to(dev)
            out = torch.zeros((len(src_idx), C, t_ext2),
                              dtype=torch.float32, device=dev)
            w_acc = torch.zeros(t_ext2, dtype=torch.float32, device=dev)
            for i in range(k * local_nb, min((k + 1) * local_nb, nb)):
                n_valid = min(batch, n_seg - i * batch)
                w0 = i * adv
                slab = mix_dev[:, w0:w0 + span]
                chunk = torch.stack([slab[:, j * stride:j * stride + seg]
                                     for j in range(n_valid)])
                st = model(chunk).index_select(1, idx)
                for j in range(n_valid):
                    s0 = w0 + j * stride
                    out[:, :, s0:s0 + seg] += st[j] * w_dev
                    w_acc[s0:s0 + seg] += w_dev
            outs.append(out)
            wss.append(w_acc)
    with torch.inference_mode():
        home = devs[0]
        out, w_acc = outs[0], wss[0]
        for o, wa in zip(outs[1:], wss[1:]):
            out = out + o.to(home)
            w_acc = w_acc + wa.to(home)
        out = (out / torch.clamp(w_acc, min=1e-8))[:, :, :T]
    return out if device_out else out.cpu().numpy()
