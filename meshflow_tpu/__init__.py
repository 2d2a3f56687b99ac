"""The package's former import name, kept so that existing imports and
``python -m <former name>.cli`` keep working.  Every attribute resolves to
:mod:`meshflow`, and submodules load from the ``meshflow`` directory (the
package has no relative imports, so they bind to ``meshflow``'s modules)."""

import meshflow as _meshflow

__path__ = list(_meshflow.__path__)
__all__ = _meshflow.__all__


def __getattr__(name):
    return getattr(_meshflow, name)
