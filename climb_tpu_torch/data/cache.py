"""Pickle caches for parsed annotations and loader hints (the port's copy of
``climb_tpu/data/cache.py``).

The caches live at the JAX package's paths under the data root
(``cached_*``) and hold the same builtin lists and dicts, so a data root
prepared by one package serves the other. Writes are tmp + rename atomic, so
a process killed mid-write never leaves a truncated cache; a missing file
loads as None, and corrupt content raises unless ``tolerant``. Loading
refuses any class of the JAX package: resolving one would import it.
"""

import os
import pickle


class _PortUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] == "climb_tpu":
            raise pickle.UnpicklingError(
                f"cache holds {module}.{name}: a class of the JAX package, which "
                "climb_tpu_torch does not import")
        return super().find_class(module, name)


def load_pickle_cache(path, tolerant: bool = False):
    if not os.path.exists(path):
        return None
    try:
        with open(path, "rb") as f:
            return _PortUnpickler(f).load()
    except Exception:
        if tolerant:
            return None
        raise


def save_pickle_cache(path, data):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            pickle.dump(data, f)
        os.replace(tmp, path)
    except OSError:
        try:
            os.remove(tmp)
        except OSError:
            pass
