from .engine import Config, instantiate, load_config, merge, to_yaml

__all__ = ["Config", "instantiate", "load_config", "merge", "to_yaml"]
