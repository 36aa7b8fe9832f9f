"""Map-version lineage: the ``versions.json`` contract under a checkpoint dir.

The port's own copy of the JAX package's ``checkpoint/lineage.py``: the
same file, keys and refusals, so a lineage either package started grows
through the other.

A ``checkpoint_dir`` that only ever sees full fits holds one map. Once
``partial_fit`` grows the corpus in place, the directory becomes a
*lineage*: each update writes a *self-contained* version subdirectory
(``<root>/v1/``, ``<root>/v2/`` … — its own ``step_*/`` checkpoint plus
``index.npz``) and appends an entry to ``<root>/versions.json``:

.. code-block:: json

    {"versions": [
      {"name": "v0", "dir": ".",  "parent": "",   "fingerprint": "9f…",
       "n_points": 100000, "kind": "fit",         "created_at": 1754…},
      {"name": "v1", "dir": "v1", "parent": "v0", "fingerprint": "3a…",
       "n_points": 101024, "kind": "partial_fit", "created_at": 1754…}
    ]}

Contract:

* ``dir`` is **relative to the lineage root** (``"."`` = the root itself —
  the base fit's artifacts stay exactly where a plain fit wrote them, so
  pre-lineage checkpoints upgrade in place as version ``v0``).
* ``parent`` names the entry the version was grown from (``""`` for a
  base fit). Parents always precede children in the list.
* ``fingerprint`` is the version's index fingerprint. A ``partial_fit``
  version carries a *chained* fingerprint — hash(parent fingerprint +
  fingerprint of the appended rows) — so identical append sequences hash
  identically while any divergence (different parent, different rows)
  is visible without re-reading the corpus.
* Every version directory is self-contained: ``FrozenMap.from_checkpoint``
  and ``NomadProjection.from_checkpoint`` work on
  ``lineage.resolve(name).path`` directly.

The file is written whole via tmp + ``os.replace`` — readers never see a
torn update, exactly like the checkpoint commit itself.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import List, Optional

VERSIONS_FILE = "versions.json"


@dataclasses.dataclass
class MapVersion:
    """One entry of ``versions.json`` (see the module contract above)."""

    name: str
    dirname: str  # relative to the lineage root; "." = the root itself
    parent: str  # "" for a base fit
    fingerprint: str
    n_points: int
    kind: str  # "fit" | "partial_fit"
    created_at: float
    root: str = ""  # absolute-ization context, not serialized

    @property
    def path(self) -> str:
        """The version's self-contained checkpoint directory."""
        return os.path.normpath(os.path.join(self.root, self.dirname))

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "dir": self.dirname,
            "parent": self.parent,
            "fingerprint": self.fingerprint,
            "n_points": int(self.n_points),
            "kind": self.kind,
            "created_at": self.created_at,
        }


class MapLineage:
    """Reader/writer of one checkpoint root's ``versions.json``."""

    def __init__(self, root: str):
        self.root = root
        self._file = os.path.join(root, VERSIONS_FILE)

    def exists(self) -> bool:
        return os.path.exists(self._file)

    def load(self) -> List[MapVersion]:
        if not self.exists():
            return []
        with open(self._file) as f:
            doc = json.load(f)
        return [
            MapVersion(
                name=v["name"],
                dirname=v["dir"],
                parent=v.get("parent", ""),
                fingerprint=v.get("fingerprint", ""),
                n_points=int(v.get("n_points", 0)),
                kind=v.get("kind", "fit"),
                created_at=float(v.get("created_at", 0.0)),
                root=self.root,
            )
            for v in doc.get("versions", [])
        ]

    def latest(self) -> Optional[MapVersion]:
        versions = self.load()
        return versions[-1] if versions else None

    def resolve(self, name: Optional[str] = None) -> MapVersion:
        """The named version (default: the newest). Raises on miss/empty."""
        versions = self.load()
        if not versions:
            raise FileNotFoundError(
                f"{self._file} has no versions — nothing fitted here yet"
            )
        if name is None:
            return versions[-1]
        for v in versions:
            if v.name == name:
                return v
        raise KeyError(
            f"unknown map version {name!r} in {self._file} "
            f"(have {[v.name for v in versions]})"
        )

    def next_name(self) -> str:
        """The next free ``vN`` (monotone even if versions were pruned)."""
        taken = {v.name for v in self.load()}
        i = len(taken)
        while f"v{i}" in taken:
            i += 1
        return f"v{i}"

    def record(
        self,
        *,
        name: str,
        dirname: str,
        parent: str,
        fingerprint: str,
        n_points: int,
        kind: str,
    ) -> MapVersion:
        """Append one version entry (atomic tmp + rename rewrite)."""
        versions = self.load()
        if any(v.name == name for v in versions):
            raise ValueError(f"map version {name!r} already recorded in {self._file}")
        if parent and not any(v.name == parent for v in versions):
            raise ValueError(
                f"parent version {parent!r} is not in {self._file} — "
                "a lineage must stay connected"
            )
        entry = MapVersion(
            name=name,
            dirname=dirname,
            parent=parent,
            fingerprint=fingerprint,
            n_points=int(n_points),
            kind=kind,
            created_at=time.time(),
            root=self.root,
        )
        versions.append(entry)
        os.makedirs(self.root, exist_ok=True)
        tmp = self._file + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"versions": [v.to_json() for v in versions]}, f, indent=1)
        os.replace(tmp, self._file)
        return entry
