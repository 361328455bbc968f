"""Root labels — named pointers into the content-addressed store.

EXTENSION (no reference analogue). Content addressing answers "are
these the bytes?" but a stateless reader still needs to learn the
CURRENT root hash out of band (the reference's examples pass it on the
command line). A label is a tiny mutable file ``labels/<name>``
holding one root hash; publishing a new database version is one atomic
label write, and readers resolve the label before the usual
``load_database(fs, f"{root}.binpb")``.

Works on every writable backend (:class:`.io.LocalFileSystem`,
:class:`.memfs.MemoryFileSystem`; on object stores the label PUT is
atomic, which is exactly the compare-free "publish" serverless
deployments want).

A copy of the JAX package's ``catalog.py`` (for the reason given in
:mod:`.errors`); :func:`load_labeled` loads through the port's
:func:`.stored.load_database`.
"""

from __future__ import annotations

import re

from .errors import InvalidArgs, IOError_
from .io import FileSystem

_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")

#: Subdirectory holding label files (never content-addressed).
LABEL_DIR = "labels"


def _check_name(name: str) -> str:
    if not _NAME_RE.match(name or ""):
        raise InvalidArgs(
            f"invalid label name: {name!r} (want [A-Za-z0-9._-], "
            "max 64 chars, not starting with a separator)")
    return name


def publish_label(fs: FileSystem, root: str, name: str = "latest",
                  extension: str = "binpb") -> None:
    """Points ``labels/<name>`` at root hash ``root`` (atomically).

    The root artifact must already exist in ``fs`` — a label must never
    dangle at publish time (crash consistency: artifacts first, root
    second, label last).
    """
    _check_name(name)
    root = root.strip()
    if not root or "/" in root or "." in root:
        raise InvalidArgs(f"not a root hash: {root!r}")
    # Existence probe (metadata stat, never a download); a label must
    # not be published over a root that was never persisted.
    if not fs.exists(f"{root}.{extension}"):
        raise IOError_(f"root {root} is not in the store")
    fs.write_named(f"{LABEL_DIR}/{name}", f"{root}\n".encode())


def resolve_label(fs: FileSystem, name: str = "latest") -> str:
    """Returns the root hash ``labels/<name>`` points at."""
    _check_name(name)
    try:
        data = fs.read_named(f"{LABEL_DIR}/{name}")
    except IOError_:
        raise InvalidArgs(f"no such label: {name!r}") from None
    root = data.decode("utf-8", "replace").strip()
    if not root or "\n" in root or "/" in root:
        raise InvalidArgs(f"malformed label {name!r}: {data[:80]!r}")
    return root


def load_labeled(fs: FileSystem, name: str = "latest",
                 extension: str = "binpb", device="cuda"):
    """``load_database(fs, f"{resolve_label(fs, name)}.binpb", device)``."""
    from .stored import load_database

    return load_database(fs, f"{resolve_label(fs, name)}.{extension}",
                         device=device)
