"""configargparse-compatible argument parsing (copy of lidarnerf_tpu/utils/config.py).

The CLI reads `key = value` config files (configs/*.txt), as configargparse
does. configargparse is not a dependency, so this module provides the subset
the CLI uses, reading the same config files unchanged:

- `parser.add_argument("--config", is_config_file=True)` marks the config flag,
- config lines `key = value` (or `key=value`) set argument defaults,
- bracketed lists `[2, 8]` feed nargs='+' arguments,
- `True`/`False` drive store_true actions,
- command-line values override config-file values.
"""

import argparse
import ast


class ConfigArgumentParser(argparse.ArgumentParser):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._config_arg_names = []

    def add_argument(self, *args, **kwargs):
        is_config_file = kwargs.pop("is_config_file", False)
        action = super().add_argument(*args, **kwargs)
        if is_config_file:
            self._config_arg_names.append(action.dest)
        return action

    def _find_action(self, dest):
        for a in self._actions:
            if a.dest == dest:
                return a
        return None

    def _coerce(self, action, raw):
        raw = raw.strip()
        if isinstance(action, (argparse._StoreTrueAction, argparse._StoreFalseAction)):
            return raw.lower() in ("true", "1", "yes")
        if raw.startswith("["):
            vals = ast.literal_eval(raw)
            typ = action.type or (lambda x: x)
            return [typ(v) for v in vals]
        if action.nargs in ("+", "*"):
            typ = action.type or (lambda x: x)
            return [typ(v) for v in raw.split()]
        if action.type is not None:
            return action.type(raw)
        return raw

    def parse_args(self, args=None, namespace=None):
        # first pass: only to discover the config file path
        pre, _ = super().parse_known_args(args=args, namespace=None)
        overrides = {}
        for name in self._config_arg_names:
            path = getattr(pre, name, None)
            if path:
                overrides.update(self._read_config(path))
        if overrides:
            self.set_defaults(**overrides)
        ns = super().parse_args(args=args, namespace=namespace)
        return ns

    def _read_config(self, path):
        out = {}
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith(("#", ";")):
                    continue
                if "=" in line:
                    key, _, val = line.partition("=")
                elif ":" in line:
                    key, _, val = line.partition(":")
                else:
                    parts = line.split(None, 1)
                    if len(parts) != 2:
                        continue
                    key, val = parts
                key = key.strip().lstrip("-")
                action = self._find_action(key)
                if action is None:
                    continue
                out[key] = self._coerce(action, val)
        return out


# Drop-in alias so callers can `from lidarnerf_tpu_torch.utils.config import ArgumentParser`
ArgumentParser = ConfigArgumentParser
