"""YAML configs: the swap CLI's list of pairs.

Port of ``load_yaml`` from ``vface_tpu/utils/config.py`` (PyYAML's
``safe_load``; the JAX package takes OmegaConf first where it is installed,
which reads the same plain YAML to the same containers).
"""

from __future__ import annotations


def load_yaml(path: str):
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)
