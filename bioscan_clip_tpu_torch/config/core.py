"""Typed-ish config system, YAML-compatible with the reference's Hydra setup.

A copy of bioscan_clip_tpu/config/core.py for the port, over its own copy of
the YAML tree. `yaml` is imported only where YAML is read or written, so a
config built in code (`ConfigNode({...})`) needs no PyYAML.

The reference composes `global_config.yaml` with one of 19 model-config YAMLs
via Hydra (`scripts/train_cl.py:245`, `bioscanclip/config/global_config.yaml:3-5`)
and relies on OmegaConf `${a.b}` interpolation and `hasattr` probing of
optional keys (e.g. `train_cl.py:155-181`). Hydra is not a dependency here;
this module reimplements the subset actually used:

- attribute access (`cfg.model_config.batch_size`) with working `hasattr`
- `${path.to.key}` interpolation, resolved against the root config
- composition: `load_config(model_config="name")` merges
  `model_config/<name>.yaml` under the `model_config` key
- CLI override syntax `a.b=value` / `model_config=NAME` (README.md:129)
- in-place mutation (scripts overwrite e.g. batch_size, cf.
  `inference_and_eval.py:846`)
"""

from __future__ import annotations

import json
import os
import re
from pathlib import Path

_CONFIG_DIR = Path(__file__).parent
_INTERP_RE = re.compile(r"\$\{([^}]+)\}")


class ConfigNode(dict):
    """A dict with attribute access and lazy `${...}` interpolation.

    Interpolations resolve against the root node at *access* time, so
    `project_root_path` can be overwritten after load (as `train_cl.py:248`
    does) and downstream paths pick it up.
    """

    def __init__(self, data=None, root=None):
        super().__init__()
        self.__dict__["_root"] = root if root is not None else self
        if data:
            for k, v in data.items():
                self[k] = v

    # -- construction ------------------------------------------------------
    def __setitem__(self, key, value):
        if isinstance(value, dict) and not isinstance(value, ConfigNode):
            value = ConfigNode(value, root=self.__dict__["_root"])
        super().__setitem__(key, value)

    def __setattr__(self, key, value):
        self[key] = value

    # -- access ------------------------------------------------------------
    def _resolve(self, value):
        if isinstance(value, str) and "${" in value:
            root = self.__dict__["_root"]

            def sub(m):
                path = m.group(1)
                if path.startswith("hydra:"):
                    return os.getcwd()
                node = root
                for part in path.split("."):
                    node = node[part]
                return str(node)

            # Repeat until fixed point (nested interpolations).
            prev = None
            while prev != value and "${" in value:
                prev = value
                value = _INTERP_RE.sub(sub, value)
        return value

    def __getitem__(self, key):
        return self._resolve(super().__getitem__(key))

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default

    # -- utilities -----------------------------------------------------------
    def set_root(self, root):
        self.__dict__["_root"] = root
        for v in super().values():
            if isinstance(v, ConfigNode):
                v.set_root(root)

    def merge(self, other: dict):
        for k, v in other.items():
            if (
                k in self
                and isinstance(super().__getitem__(k), ConfigNode)
                and isinstance(v, dict)
            ):
                super().__getitem__(k).merge(v)
            else:
                self[k] = v

    def to_dict(self, resolve: bool = True) -> dict:
        out = {}
        for k in super().keys():
            v = self[k] if resolve else super().__getitem__(k)
            out[k] = v.to_dict(resolve) if isinstance(v, ConfigNode) else v
        return out

    def override(self, dotted_key: str, value):
        """Apply one `a.b.c=value` style override."""
        parts = dotted_key.split(".")
        node = self
        for p in parts[:-1]:
            if p not in node:
                node[p] = {}
            node = super(ConfigNode, node).__getitem__(p)
        node[parts[-1]] = value


def _parse_scalar(s: str):
    import yaml

    return yaml.safe_load(s)


def find_model_config(name: str, search_dir: Path | None = None) -> Path:
    """Find `<name>.yaml` under the model_config tree (supports the nested
    groups like `full_fine_tuning/cosin/...` the reference ships)."""
    search_dir = search_dir or (_CONFIG_DIR / "model_config")
    direct = search_dir / f"{name}.yaml"
    if direct.exists():
        return direct
    hits = sorted(search_dir.rglob(f"{Path(name).name}.yaml"))
    if not hits:
        raise FileNotFoundError(f"model_config '{name}' not found under {search_dir}")
    return hits[0]


def load_config(
    model_config: str | None = None,
    overrides: list | None = None,
    global_config_path: str | None = None,
    project_root_path: str | None = None,
) -> ConfigNode:
    """Compose global config + model config + CLI-style overrides.

    Mirrors `@hydra.main(config_name="global_config")` + `model_config=NAME`
    composition (train_cl.py:245, README.md:129).
    """
    import yaml

    gpath = Path(global_config_path or (_CONFIG_DIR / "global_config.yaml"))
    with open(gpath) as f:
        raw = yaml.safe_load(f) or {}
    defaults = raw.pop("defaults", None)
    cfg = ConfigNode(raw)

    # default model_config from the defaults list, if present
    default_mc = None
    if defaults:
        for item in defaults:
            if isinstance(item, dict) and "model_config" in item:
                default_mc = item["model_config"]

    overrides = list(overrides or [])
    for ov in list(overrides):
        if ov.startswith("model_config="):
            model_config = ov.split("=", 1)[1].strip("'\"")
            overrides.remove(ov)
    model_config = model_config or default_mc

    if model_config:
        mc_path = find_model_config(model_config, gpath.parent / "model_config")
        with open(mc_path) as f:
            mc_raw = yaml.safe_load(f) or {}
        cfg["model_config"] = mc_raw

    if project_root_path is not None:
        cfg["project_root_path"] = project_root_path
    elif "project_root_path" not in cfg:
        cfg["project_root_path"] = os.getcwd()

    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"Bad override (expected key=value): {ov}")
        k, v = ov.split("=", 1)
        cfg.override(k, _parse_scalar(v))

    return cfg


def save_config(cfg: ConfigNode, path: str, resolve: bool = False):
    """Snapshot the config (cf. OmegaConf.save in train_cl.py:206). Where
    PyYAML is not installed the file is JSON, which YAML reads too."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    data = cfg.to_dict(resolve=resolve)
    try:
        import yaml
    except ImportError:
        yaml = None
    with open(path, "w") as f:
        if yaml is None:
            json.dump(data, f, indent=2, default=str)
        else:
            yaml.safe_dump(data, f, sort_keys=False)
