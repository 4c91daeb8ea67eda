"""Atomic, async checkpointing with template restore (port of
`repro.checkpoint.manager`).

The on-disk format is the reference's, so a checkpoint written by either
package restores in the other:

  * one `arrays.npz` per checkpoint, every leaf of the state under its path
    rendered as the reference renders it (`jax.tree_util.keystr`: a dict key
    as `['key']`, a NamedTuple field as `.name`, a list or plain tuple
    position as `[0]`, nested paths concatenated), leaves in the reference's
    flattening order (dict keys sorted);
  * `manifest.json` with `step`, the sorted `keys`, `nbytes` and the JSON
    `meta` when given;
  * writes go to `step_XXXXXXXX.<pid>-<thread>.tmp/` and then `os.replace`
    to `step_XXXXXXXX/`: a crashed writer never leaves a checkpoint that
    `latest_step` or a restore would accept;
  * async mode: the host copy of the state is made synchronously (a
    consistent snapshot), the file write on a background thread;
  * keep-K garbage collection and an optional SIGTERM save hook;
  * `restore` takes a template (a nested dict, list, tuple or NamedTuple of
    tensors or arrays) and a `device=` for the restored tensors, in place of the
    reference's JAX shardings; `restore_flat` is template-free and returns
    the flat arrays plus `meta` (the service checkpoints its tenants' slabs
    this way, since their shapes drift with the ingested deltas).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import signal
import threading
from typing import Any, Callable, Optional

import numpy as np
import torch

__all__ = ["CheckpointManager", "latest_step"]

# How `_flatten` renders a FLAT dict's string key: exactly one dict-key
# component.  `restore_flat` unwraps these so flat-dict states round-trip
# with their original keys.
_FLAT_DICT_KEY = re.compile(r"^\['([^]\[']*)'\]$")


def _host(leaf) -> np.ndarray:
    """A leaf as a host numpy array (bf16 tensors as their int16 bits,
    which numpy can store)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().copy()
    return np.asarray(leaf)


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _items(tree, path: str = ""):
    """(rendered path, leaf) of every leaf, in the reference's order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], f"{path}[{k!r}]")
    elif _is_namedtuple(tree):
        for name, v in zip(tree._fields, tree):
            yield from _items(v, f"{path}.{name}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, f"{path}[{i}]")
    else:
        yield path, tree


def _flatten(tree) -> dict[str, np.ndarray]:
    return {key: _host(leaf) for key, leaf in _items(tree)}


def _unflatten(template, leaves: dict, path: str = ""):
    if isinstance(template, dict):
        return {k: _unflatten(v, leaves, f"{path}[{k!r}]") for k, v in template.items()}
    if _is_namedtuple(template):
        return type(template)(*(_unflatten(v, leaves, f"{path}.{name}")
                                for name, v in zip(template._fields, template)))
    if isinstance(template, (list, tuple)):
        out = [_unflatten(v, leaves, f"{path}[{i}]") for i, v in enumerate(template)]
        return type(template)(out) if isinstance(template, tuple) else out
    return leaves[path]


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            manifest = os.path.join(directory, name, "manifest.json")
            if os.path.exists(manifest):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


class CheckpointManager:
    def __init__(
        self,
        directory: str,
        *,
        keep: int = 3,
        async_write: bool = True,
        save_on_sigterm: bool = False,
    ):
        self.directory = directory
        self.keep = keep
        self.async_write = async_write
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._last_state_fn: Optional[Callable[[], tuple[int, Any]]] = None
        if save_on_sigterm:
            signal.signal(signal.SIGTERM, self._sigterm)

    # -- save -----------------------------------------------------------------

    def save(
        self, step: int, state, *, block: bool = False, meta: Optional[dict] = None
    ) -> None:
        """Snapshot (device->host now) and write (async unless block=True).

        ``meta`` (JSON-able) is stored in the manifest and returned by
        `read_meta` / `restore_flat`.
        """
        self.wait()  # never two writers in flight (same-step collisions)
        host = _flatten(state)
        if self.async_write and not block:
            self._thread = threading.Thread(
                target=self._write, args=(step, host, meta), daemon=True
            )
            self._thread.start()
        else:
            self._write(step, host, meta)

    def _write(
        self, step: int, host: dict[str, np.ndarray], meta: Optional[dict] = None
    ) -> None:
        final = os.path.join(self.directory, f"step_{step:08d}")
        tmp = final + f".{os.getpid()}-{threading.get_ident()}.tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **host)
        manifest = {
            "step": step,
            "keys": sorted(host.keys()),
            "nbytes": int(sum(a.nbytes for a in host.values())),
        }
        if meta is not None:
            manifest["meta"] = meta
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()

    def wait(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()

    def _gc(self) -> None:
        steps = sorted(
            int(n.split("_")[1])
            for n in os.listdir(self.directory)
            if n.startswith("step_") and not n.endswith(".tmp")
            and os.path.exists(os.path.join(self.directory, n, "manifest.json"))
        )
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"))

    # -- restore ----------------------------------------------------------------

    def restore(self, step: int, template, device=None):
        """Rebuild `template`'s structure from disk: every leaf a tensor of
        the template leaf's dtype (a tensor or a numpy array), on `device`
        (the CPU when None)."""
        path = os.path.join(self.directory, f"step_{step:08d}")
        leaves = {}
        with np.load(os.path.join(path, "arrays.npz")) as data:
            for key, leaf in _items(template):
                arr = data[key]
                if tuple(arr.shape) != tuple(leaf.shape):
                    raise ValueError(
                        f"checkpoint leaf {key}: shape {arr.shape} != template "
                        f"{tuple(leaf.shape)}"
                    )
                t = torch.from_numpy(arr.copy())
                dtype = leaf.dtype if isinstance(leaf, torch.Tensor) else \
                    torch.from_numpy(np.zeros(0, leaf.dtype)).dtype
                leaves[key] = t.to(device=device or "cpu", dtype=dtype)
        return _unflatten(template, leaves)

    def restore_flat(self, step: int) -> tuple[dict[str, np.ndarray], dict]:
        """Template-free restore: (flat key -> array, manifest meta).

        States saved as a flat `{str: array}` dict round-trip with their
        original keys (the rendering `save` applies is undone here); nested
        keys come back rendered.
        """
        path = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        arrays = {}
        with np.load(os.path.join(path, "arrays.npz")) as data:
            for k in data.files:
                m = _FLAT_DICT_KEY.match(k)
                arrays[m.group(1) if m else k] = data[k].copy()
        return arrays, manifest.get("meta", {})

    def read_meta(self, step: int) -> dict:
        """The JSON ``meta`` recorded with `save` (empty dict when absent)."""
        path = os.path.join(self.directory, f"step_{step:08d}", "manifest.json")
        with open(path) as f:
            return json.load(f).get("meta", {})

    # -- preemption -------------------------------------------------------------

    def attach_state_provider(self, fn: Callable[[], tuple[int, Any]]) -> None:
        """fn() -> (step, state) used by the SIGTERM hook."""
        self._last_state_fn = fn

    def _sigterm(self, signum, frame):
        if self._last_state_fn is not None:
            step, state = self._last_state_fn()
            self.save(step, state, block=True)
        raise SystemExit(143)
