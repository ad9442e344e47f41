"""Centralised env-driven configuration: the port's copy of
``mdx/serve/config.py`` (ref backend/config.py:19-42).

Same three-layer precedence as the reference: CLI/API body > env vars >
defaults.  ``.env`` files are honoured via a tiny built-in loader
(python-dotenv is not a dependency here).  ``_ROOT`` is the root of the
checkout, as for the JAX package, so ``uploads/``, ``outputs/`` and
``data/mdx.db`` are the same defaults and one DB file serves both
packages.
"""

from __future__ import annotations

import os
import secrets


def _load_dotenv(path: str = ".env") -> None:
    """Minimal KEY=VALUE .env loader (no interpolation, # comments)."""
    try:
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#") or "=" not in line:
                    continue
                k, _, v = line.partition("=")
                os.environ.setdefault(k.strip(), v.strip().strip("'\""))
    except OSError:
        pass


_load_dotenv()

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# --- OpenAI-compatible LLM endpoint (the run-scoped chat) ---
OPENAI_API_KEY: str = os.environ.get("OPENAI_API_KEY", "")
OPENAI_MODEL: str = os.environ.get("OPENAI_MODEL", "gpt-5-mini")
MAX_ITERS: int = int(os.environ.get("MAX_ITERS", "2"))

# --- Paths ---
UPLOAD_DIR: str = os.environ.get("UPLOAD_DIR", os.path.join(_ROOT, "uploads"))
OUTPUT_DIR: str = os.environ.get("OUTPUT_DIR", os.path.join(_ROOT, "outputs"))
# MDIMG_DB_PATH honoured for drop-in compatibility with reference deploys
MDX_DB_PATH: str = (os.environ.get("MDX_DB_PATH")
                    or os.environ.get("MDIMG_DB_PATH")
                    or os.path.join(_ROOT, "data", "mdx.db"))

# --- HTTP ---
SECRET_KEY: str = os.environ.get("SECRET_KEY", secrets.token_hex(32))
DEBUG: bool = os.environ.get("MDX_DEBUG", "0").lower() in ("1", "true", "yes")
MAX_CONTENT_LENGTH: int = 50 * 1024 * 1024  # 50 MB upload cap
MAX_CONCURRENT_RUNS: int = int(os.environ.get("MDX_MAX_CONCURRENT_RUNS", "4"))


def apply_to_env() -> None:
    """Push config values into os.environ for the pipeline layer, which
    reads OPENAI_API_KEY / OPENAI_MODEL / MDX_DB_PATH directly."""
    if OPENAI_API_KEY:
        os.environ.setdefault("OPENAI_API_KEY", OPENAI_API_KEY)
    os.environ["OPENAI_MODEL"] = OPENAI_MODEL
    os.environ["MDX_DB_PATH"] = MDX_DB_PATH
