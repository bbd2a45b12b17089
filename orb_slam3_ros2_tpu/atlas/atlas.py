"""Atlas: multi-map store with serialization (E9).

Reference behavior: `Atlas` holds the active map plus all previous
(non-active) maps; on tracking loss a fresh map is spawned and later merged
when place recognition finds overlap; the whole atlas serializes via
`System.SaveAtlasToFile` / `LoadAtlasFromFile`
(`/root/reference/config/Monocular/MilkV.yaml:74-75`,
`config/Stereo/EuRoC.yaml:7-13` — "if LoadFile doesn't exist … create new
Atlas from scratch") [upstream Boost serialization].

Design: each map is already a flat pytree of arrays (atlas.map_state),
so serialization is a plain `.npz` of leaves — deterministic, portable,
versioned. The BoW database rides along for relocalization into old maps.
"""

from __future__ import annotations

import os
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from orb_slam3_ros2_tpu.atlas import map_state as ms
from orb_slam3_ros2_tpu.loop import vocab

FORMAT_VERSION = 1


class Atlas:
    """Active map + frozen previous maps (+ per-map BoW databases)."""

    def __init__(self, cfg: ms.MapConfig):
        self.cfg = cfg
        self.maps: List[ms.MapState] = [ms.empty_map(cfg)]
        self.bow_dbs: List[vocab.BowDatabase] = [
            vocab.empty_database(cfg.max_kf)
        ]
        self.active = 0

    # -- reference-API surface ------------------------------------------

    @property
    def current_map(self) -> ms.MapState:
        return self.maps[self.active]

    @current_map.setter
    def current_map(self, m: ms.MapState) -> None:
        self.maps[self.active] = m

    @property
    def current_bow(self) -> vocab.BowDatabase:
        return self.bow_dbs[self.active]

    @current_bow.setter
    def current_bow(self, db: vocab.BowDatabase) -> None:
        self.bow_dbs[self.active] = db

    def create_new_map(self) -> int:
        """Spawn a fresh active map (tracking-loss path [upstream])."""
        self.maps.append(ms.empty_map(self.cfg))
        self.bow_dbs.append(vocab.empty_database(self.cfg.max_kf))
        self.active = len(self.maps) - 1
        return self.active

    def n_maps(self) -> int:
        return len(self.maps)

    def total_landmarks(self) -> int:
        return int(sum(np.asarray(m.lm_valid).sum() for m in self.maps))

    # -- serialization ----------------------------------------------------

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        blob = {"__version__": np.asarray(FORMAT_VERSION),
                "__n_maps__": np.asarray(len(self.maps)),
                "__active__": np.asarray(self.active),
                "__cfg__": np.asarray(
                    [self.cfg.max_kf, self.cfg.max_lm, self.cfg.n_feat]
                )}
        for mi, (m, db) in enumerate(zip(self.maps, self.bow_dbs)):
            leaves, _ = jax.tree_util.tree_flatten(m)
            for li, leaf in enumerate(leaves):
                blob[f"map{mi}_leaf{li}"] = np.asarray(leaf)
            dleaves, _ = jax.tree_util.tree_flatten(db)
            for li, leaf in enumerate(dleaves):
                blob[f"bow{mi}_leaf{li}"] = np.asarray(leaf)
        np.savez_compressed(path, **blob)

    @classmethod
    def load(cls, path: str) -> "Atlas":
        if not path.endswith(".npz"):
            path = path + ".npz"
        data = np.load(path)
        version = int(data["__version__"])
        if version != FORMAT_VERSION:
            raise ValueError(f"atlas format {version} != {FORMAT_VERSION}")
        mk, ml, nf = (int(x) for x in data["__cfg__"])
        cfg = ms.MapConfig(max_kf=mk, max_lm=ml, n_feat=nf)
        atlas = cls(cfg)
        atlas.maps = []
        atlas.bow_dbs = []
        n_maps = int(data["__n_maps__"])
        m_tmpl = ms.empty_map(cfg)
        _, m_treedef = jax.tree_util.tree_flatten(m_tmpl)
        db_tmpl = vocab.empty_database(cfg.max_kf)
        _, db_treedef = jax.tree_util.tree_flatten(db_tmpl)
        for mi in range(n_maps):
            leaves = [
                jnp.asarray(data[f"map{mi}_leaf{li}"])
                for li in range(m_treedef.num_leaves)
            ]
            atlas.maps.append(jax.tree_util.tree_unflatten(m_treedef, leaves))
            dleaves = [
                jnp.asarray(data[f"bow{mi}_leaf{li}"])
                for li in range(db_treedef.num_leaves)
            ]
            atlas.bow_dbs.append(
                jax.tree_util.tree_unflatten(db_treedef, dleaves)
            )
        atlas.active = int(data["__active__"])
        return atlas
