"""Paths of the data files the port shares with the reference package.

The files under fredholm_tpu/assets/ are read by path with numpy; nothing
here imports the reference package (its __init__ imports jax)."""

from __future__ import annotations

import os

ASSET_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "fredholm_tpu", "assets",
)


def asset_path(name: str) -> str:
    return os.path.join(ASSET_DIR, name)
