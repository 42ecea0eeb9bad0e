"""Checkpoint download helper.

Equivalent of reference utils/download_util.py:83 (load_file_from_url): fetch
a released checkpoint into a local weights directory if missing. Uses only
the stdlib; in air-gapped environments it raises with clear instructions
instead of failing mid-pipeline.
"""

from __future__ import annotations

import os
import urllib.error
import urllib.request

RELEASE_BASE = ("https://github.com/sczhou/ProPainter/releases/download/v0.1.0")

RELEASED_CHECKPOINTS = {
    "raft-things.pth": f"{RELEASE_BASE}/raft-things.pth",
    "recurrent_flow_completion.pth":
        f"{RELEASE_BASE}/recurrent_flow_completion.pth",
    "ProPainter.pth": f"{RELEASE_BASE}/ProPainter.pth",
    "i3d_rgb_imagenet.pt": f"{RELEASE_BASE}/i3d_rgb_imagenet.pt",
}


def load_file_from_url(url: str, model_dir: str, file_name: str | None = None,
                       progress: bool = True) -> str:
    """Download url into model_dir (once); returns the local path."""
    os.makedirs(model_dir, exist_ok=True)
    name = file_name or os.path.basename(url.split("?")[0])
    path = os.path.abspath(os.path.join(model_dir, name))
    if os.path.exists(path):
        return path
    tmp = path + ".part"
    try:
        if progress:
            print(f"downloading {url} -> {path}", flush=True)
        urllib.request.urlretrieve(url, tmp)
        os.replace(tmp, path)
    except (urllib.error.URLError, OSError) as e:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"could not download {name} ({e}). In an offline environment, "
            f"place the released checkpoint at {path} manually "
            f"(see weights/README.md).") from e
    return path


def ensure_checkpoints(weights_dir: str, names=None) -> dict[str, str]:
    """Ensure the named released checkpoints exist locally; returns paths."""
    names = names or list(RELEASED_CHECKPOINTS)
    return {
        n: load_file_from_url(RELEASED_CHECKPOINTS[n], weights_dir)
        for n in names
    }
