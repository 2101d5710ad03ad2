"""Run the port's `cuda`-marked tests on a machine with a CUDA card and no
JAX.

The test files hold the port to the JAX reference on the CPU, so they
import jax and the JAX package at the top; the tests marked `cuda` use
neither. This answers every import of jax or of the JAX package
(`cfdnn_tpu`, not the port) with a stand-in module, then runs pytest with
`-m cuda` (by default over tests/test_torch_*.py):

    python -m cfdnn_tpu_torch.cuda_tests [pytest arguments]
"""

import importlib.abc
import importlib.machinery
import sys
from pathlib import Path
from unittest import mock

STOOD_IN = ("jax", "jaxlib", "cfdnn_tpu")


class _StandIns(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in STOOD_IN:
            return importlib.machinery.ModuleSpec(name, self,
                                                  is_package=True)
        return None

    def create_module(self, spec):
        module = mock.MagicMock()
        module.__path__ = []
        module.__spec__ = spec
        return module

    def exec_module(self, module):
        pass


def main(argv) -> int:
    import pytest
    root = Path(__file__).resolve().parents[1]
    sys.meta_path.insert(0, _StandIns())
    args = argv or sorted(str(p) for p in (root / "tests").glob(
        "test_torch_*.py"))
    return pytest.main(["-q", "-m", "cuda", "-p", "no:cacheprovider", "-rs",
                        "--rootdir", str(root), *args])


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
