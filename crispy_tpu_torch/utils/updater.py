"""Updater analog (X9: the tauri-plugin-updater wired in main.rs:221).

The port's copy of ``crispy_tpu/utils/updater.py``; ``current_version``
reads ``crispy_tpu_torch.__version__``.

The reference ships Tauri's updater plugin: the app fetches a signed
release manifest, compares versions, and installs in place. For a
pip-installed server package the honest analog is the package index:
`check_for_updates` asks PyPI for the newest `crispy-tpu` release and
reports whether an upgrade exists; *applying* it is surfaced as the
`pip install --upgrade` command rather than auto-run — a server host
should not mutate its own environment mid-session. Offline (the normal
state on a host without network access) reports `"offline"` rather than
erroring, mirroring the plugin's silent no-manifest behavior.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Dict, Optional, Tuple

PACKAGE = "crispy-tpu"
INDEX_URL = f"https://pypi.org/pypi/{PACKAGE}/json"
UPDATE_COMMAND = f"pip install --upgrade {PACKAGE}"


def _version_key(v: str) -> Tuple:
    """Order-comparable key for PEP-440-ish versions.

    dev < alpha < beta < rc < final < post (PEP 440: a user on 0.2.0rc1
    must see the final 0.2.0 as an update, not as older); the numeric
    release pads so 0.2 == 0.2.0; unknown suffixes compare lexically
    just below the final release."""
    import re

    s = v.lower().lstrip("v").replace("-", ".").replace("_", ".")
    m = re.match(r"\d+(?:\.\d+)*", s)
    nums = [int(x) for x in m.group(0).split(".")] if m else []
    release = tuple(nums + [0] * (8 - len(nums)))
    rest = (s[m.end():] if m else s).lstrip(".")
    if not rest:
        return (release, (3,))
    pm = re.match(r"(dev|alpha|beta|preview|pre|rc|post|a|b|c)\.?(\d*)", rest)
    if pm:
        rank = {"dev": -3, "a": -2, "alpha": -2, "b": -1, "beta": -1,
                "rc": 0, "c": 0, "pre": 0, "preview": 0, "post": 4}[pm.group(1)]
        return (release, (rank, int(pm.group(2) or 0)))
    return (release, (2, rest))


def current_version() -> str:
    from .. import __version__

    return __version__


def check_for_updates(timeout: float = 5.0,
                      index_url: Optional[str] = None) -> Dict[str, str]:
    """One-shot update check → status dict (never raises).

    status: "update-available" | "up-to-date" | "offline".
    """
    cur = current_version()
    out = {"status": "offline", "current_version": cur,
           "update_command": UPDATE_COMMAND}
    try:
        with urllib.request.urlopen(index_url or INDEX_URL,
                                    timeout=timeout) as r:
            info = json.loads(r.read())
        latest = str(info["info"]["version"])
    except Exception:  # DNS failure, timeout, bad JSON: all mean "no manifest"
        return out
    out["latest_version"] = latest
    out["status"] = ("update-available"
                     if _version_key(latest) > _version_key(cur)
                     else "up-to-date")
    return out
