"""Bilingual product knowledge base — the single source of truth the AI
assistant grounds its answers in (reference: bot/knowledge_base.py, injected
into the LLM system prompt at ai.py:486-491 for both the Telegram bot and
the web chat).

Unlike the reference's hand-written document, the tables here are GENERATED
from the framework's own constants (STYLE_CONFIGS / PRESET_LUFS /
DENOISE_PRESETS and the settings-store upload policy), so the assistant can
never drift from what the DSP actually does.

The port's copy of ``amw_tpu/runtime/knowledge.py``.
"""

from __future__ import annotations

from ..constants import DENOISE_PRESETS, PRESET_LUFS, STYLE_CONFIGS

_STYLE_DESC_EN = {
    "standard": "Streaming (Spotify, Apple Music, YouTube Music)",
    "edm": "Electronic music, club-ready loudness",
    "hiphop": "Hip-hop, trap, R&B",
    "classical": "Classical, chamber, orchestral",
    "podcast": "Podcasts, voice content",
    "lofi": "Lo-fi, vintage, warm",
    "house_basic": "House / tech-house club boost",
    "dry_vocal": "Dry vocal, flat response",
}
_STYLE_DESC_RU = {
    "standard": "Стриминг (Spotify, Apple Music, YouTube Music)",
    "edm": "Электронная музыка, клубный саунд",
    "hiphop": "Хип-хоп, трэп, R&B",
    "classical": "Классика, камерная музыка, оркестр",
    "podcast": "Подкасты, голосовой контент",
    "lofi": "Lo-fi, винтажный, тёплый звук",
    "house_basic": "Хаус, тек-хаус, клубный буст",
    "dry_vocal": "Сухой вокал, ровная АЧХ",
}

_PRO_EN = """\
1. **Spectral Denoiser** — Wiener-filter noise removal; `denoise_strength`
   (0-1) or a preset ({presets}).
2. **De-esser** — tames sibilance (s/sh); `deesser_threshold` (-30..-10 dB).
3. **Transient Designer** — attack/sustain control for drums;
   `transient_attack`, `transient_sustain`.
4. **Parallel Compression** — New-York style blend; `parallel_mix` (0-1).
5. **Dynamic EQ** — 8 bell bands duck only when a band gets harsh.
6. **Rumble Filter** — high-pass 20-200 Hz (`rumble_cutoff`).
7. **True-Peak Limiter** — optional 4x-oversampled dBTP ceiling
   (`true_peak_enabled`, `true_peak_ceiling_db`).
8. **Vocal Isolation** — htdemucs two-stem split before mastering.
9. **Reference Match** — match the tonal balance of a reference track.
10. **Upscale/Resample** — export at 48/96/192 kHz."""

_PRO_RU = """\
1. **Spectral Denoiser** — шумоподавление Wiener-фильтром;
   `denoise_strength` (0-1) или пресет ({presets}).
2. **De-esser** — подавление сибилянтов (с/ш); `deesser_threshold`
   (-30..-10 dB).
3. **Transient Designer** — контроль атаки/сустейна;
   `transient_attack`, `transient_sustain`.
4. **Parallel Compression** — нью-йоркская компрессия; `parallel_mix` (0-1).
5. **Dynamic EQ** — 8 колоколов, срезают только резкие всплески.
6. **Rumble Filter** — обрезной НЧ-фильтр 20-200 Гц (`rumble_cutoff`).
7. **True-Peak Limiter** — 4x-оверсэмпл потолок dBTP
   (`true_peak_enabled`, `true_peak_ceiling_db`).
8. **Vocal Isolation** — выделение вокала (htdemucs) перед мастерингом.
9. **Reference Match** — подгонка тонального баланса под референс.
10. **Upscale/Resample** — экспорт в 48/96/192 кГц."""


def _styles_table(lang: str) -> str:
    desc = _STYLE_DESC_RU if lang == "ru" else _STYLE_DESC_EN
    head = ("| Стиль | LUFS | Описание |" if lang == "ru"
            else "| Style | LUFS | Description |")
    rows = [head, "|---|---|---|"]
    for name, cfg in STYLE_CONFIGS.items():
        rows.append(f"| {name} | {cfg['lufs']:g} | {desc.get(name, '')} |")
    return "\n".join(rows)


def _presets_lines(lang: str) -> str:
    tail = ", True Peak ≤ −1 dBTP"  # reads the same in EN and RU
    return "\n".join(
        f"- {name}: {lufs:g} LUFS" + (tail if name == "spotify" else "")
        for name, lufs in PRESET_LUFS.items())


def _limits_lines(lang: str) -> str:
    try:
        from .settings_store import get_max_upload_mb

        wav = get_max_upload_mb("x.wav", "studio")
        mp3 = get_max_upload_mb("x.mp3", "studio")
        flac = get_max_upload_mb("x.flac", "studio")
        free = get_max_upload_mb("x.wav", "free")
        pro = get_max_upload_mb("x.wav", "pro")
    except Exception:  # noqa: BLE001 — knowledge must render without a DB
        wav, mp3, flac, free, pro = 800, 300, 500, 100, 300
    if lang == "ru":
        return (f"- Форматы: WAV до {wav} МБ, MP3 до {mp3} МБ, FLAC до "
                f"{flac} МБ\n- Тарифы: Free до {free} МБ, Pro до {pro} МБ, "
                f"Studio до {wav} МБ\n- Результат: WAV/FLAC/MP3/OPUS/AAC")
    return (f"- Formats: WAV up to {wav} MB, MP3 up to {mp3} MB, FLAC up to "
            f"{flac} MB\n- Tiers: Free up to {free} MB, Pro up to {pro} MB, "
            f"Studio up to {wav} MB\n- Output: WAV/FLAC/MP3/OPUS/AAC")


def product_knowledge(lang: str = "en") -> str:
    """Markdown knowledge document for the given language ('en'|'ru')."""
    lang = "ru" if str(lang).lower().startswith("ru") else "en"
    presets = ", ".join(DENOISE_PRESETS)
    if lang == "ru":
        return (
            "## О продукте\n"
            "Magic Master — онлайн-сервис профессионального мастеринга "
            "аудио на TPU. Загрузите трек → выберите стиль → готовый мастер "
            "за секунды. Подходит для AI-музыки (Suno, Udio).\n\n"
            "## Стили мастеринга\n" + _styles_table("ru") + "\n\n"
            "## Платформенные пресеты\n" + _presets_lines("ru") + "\n\n"
            "## PRO-модули\n" + _PRO_RU.format(presets=presets) + "\n\n"
            "## Лимиты и форматы\n" + _limits_lines("ru") + "\n\n"
            "## Инструменты\n- Бесплатный LUFS-анализатор (/lufs-analyzer): "
            "integrated LUFS, true peak 4x, LRA, готовность к платформам.\n"
            "- Telegram-бот: /master, /analyze, пресеты, AI-чат, привязка "
            "аккаунта.\n- Реферальная программа: 3 токена пригласившему, "
            "2 — приглашённому после первого мастеринга."
        )
    return (
        "## About the product\n"
        "Magic Master is an online professional audio-mastering service "
        "running on TPUs. Upload a track, pick a style, get a finished "
        "master in seconds. Great for AI-generated music (Suno, Udio).\n\n"
        "## Mastering styles\n" + _styles_table("en") + "\n\n"
        "## Platform presets\n" + _presets_lines("en") + "\n\n"
        "## PRO modules\n" + _PRO_EN.format(presets=presets) + "\n\n"
        "## Limits and formats\n" + _limits_lines("en") + "\n\n"
        "## Tools\n- Free LUFS analyzer (/lufs-analyzer): integrated LUFS, "
        "4x-oversampled true peak, LRA, platform readiness.\n"
        "- Telegram bot: /master, /analyze, presets, AI chat, account "
        "linking.\n- Referral program: 3 tokens for the inviter, 2 for the "
        "invitee after their first mastering."
    )
