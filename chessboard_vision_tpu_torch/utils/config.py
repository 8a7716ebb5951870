"""Config persistence: the four JSON config files + .env loading.

Same on-disk formats as the reference (SURVEY.md §5 checkpoint/resume):
calibration.json (corners, player_color, orientation_flipped,
grid_lines_x/y), color_profile.json, piece_detector_settings.json,
sensitivity_settings.json, and LICHESS_TOKEN from .env (no python-dotenv
dependency — a minimal parser here).
"""

from __future__ import annotations

import json
import os
from typing import Optional

CALIBRATION_FILE = "calibration.json"
COLOR_PROFILE_FILE = "color_profile.json"
PIECE_SETTINGS_FILE = "piece_detector_settings.json"
SENSITIVITY_FILE = "sensitivity_settings.json"


def load_json_config(path: str, default=None):
    """Load a JSON config; returns ``default`` on missing/invalid file."""
    try:
        if os.path.exists(path):
            with open(path, "r") as f:
                return json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"[config] error loading {path}: {e}")
    return default


def save_json_config(path: str, config: dict) -> bool:
    try:
        with open(path, "w") as f:
            json.dump(config, f, indent=4)
        return True
    except OSError as e:
        print(f"[config] error saving {path}: {e}")
        return False


def load_dotenv(path: str = ".env") -> dict:
    """Minimal .env parser: KEY=VALUE lines into os.environ (no override)."""
    loaded = {}
    try:
        with open(path, "r") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#") or "=" not in line:
                    continue
                key, _, value = line.partition("=")
                key = key.strip()
                value = value.strip().strip("'\"")
                loaded[key] = value
                os.environ.setdefault(key, value)
    except OSError:
        pass
    return loaded


def get_lichess_token(env_path: str = ".env") -> Optional[str]:
    load_dotenv(env_path)
    return os.environ.get("LICHESS_TOKEN")
