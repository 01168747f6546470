"""Prompt-injection guard for LLM inputs (reference: backend/app/llm_guard.py).

Forbidden-substring/regex filtering, per-context length caps, sanitization.
Lists are overridable via the settings store (``llm_guard_forbidden`` JSON
list, ``llm_guard_regex``).

The port's copy of ``amw_tpu/runtime/llm_guard.py``.
"""

from __future__ import annotations

import json
import re
from typing import Optional

from . import settings_store

_DEFAULT_FORBIDDEN = [
    "ignore previous instructions",
    "ignore all previous",
    "disregard your instructions",
    "system prompt",
    "you are now",
    "jailbreak",
    "developer mode",
    "выведи системный промпт",
    "игнорируй инструкции",
    "забудь инструкции",
]

_MAX_LEN = {"recommend": 4000, "report": 6000, "nl_config": 1000, "chat": 2000}


def _forbidden() -> list[str]:
    raw = settings_store.get_setting_str("llm_guard_forbidden", None)
    if raw:
        try:
            lst = json.loads(raw)
            if isinstance(lst, list):
                return [str(x).strip().lower() for x in lst if x]
        except json.JSONDecodeError:
            pass
    return _DEFAULT_FORBIDDEN


def _forbidden_regex() -> Optional[re.Pattern]:
    raw = settings_store.get_setting_str("llm_guard_regex", None)
    if raw:
        try:
            return re.compile(raw, re.IGNORECASE)
        except re.error:
            return None
    return None


def sanitize_text(text: str) -> str:
    text = re.sub(r"[\x00-\x08\x0b\x0c\x0e-\x1f]", "", text or "")
    return text.strip()


def validate_llm_input(text: str, context: str = "chat") -> tuple[bool, Optional[str], str]:
    """-> (ok, error, sanitized)."""
    cleaned = sanitize_text(text)
    max_len = int(settings_store.get_setting_int(
        f"llm_guard_max_{context}", _MAX_LEN.get(context, 2000)))
    if len(cleaned) > max_len:
        return False, f"Input too long (max {max_len} characters)", cleaned[:max_len]
    low = cleaned.lower()
    for sub in _forbidden():
        if sub in low:
            return False, "Input contains disallowed content", cleaned
    rx = _forbidden_regex()
    if rx and rx.search(cleaned):
        return False, "Input contains disallowed content", cleaned
    return True, None, cleaned


def validate_chat_message(content: str, role: str) -> tuple[bool, Optional[str], str]:
    if role not in ("user", "assistant"):
        return False, "Invalid role", ""
    return validate_llm_input(content, "chat")
