"""ANSI terminal colour helpers (port of botsort_tpu/utils/colors.py: the
reference's Color enum as plain functions)."""

from __future__ import annotations

_RESET = "\033[0m"


def _wrap(code: str):
    def f(s: object) -> str:
        return f"{code}{s}{_RESET}"

    return f


red = _wrap("\033[31m")
green = _wrap("\033[32m")
yellow = _wrap("\033[33m")
blue = _wrap("\033[34m")
magenta = _wrap("\033[35m")
cyan = _wrap("\033[36m")
bold = _wrap("\033[1m")
