"""Optional packages (counterpart of ``lightgbm_tpu/compat.py``).

reference: python-package/lightgbm/compat.py.  The flags say whether
pandas, matplotlib and scikit-learn are installed without importing
them (``importlib.util.find_spec``), so ``import lightgbm_tpu_torch``
costs nothing and works where they are absent; the code that needs one
imports it where it runs.  The scikit-learn base classes are
resolved here, for ``sklearn.py`` only.
"""

from __future__ import annotations

import importlib.util


def _installed(name: str) -> bool:
    try:
        return importlib.util.find_spec(name) is not None
    except (ImportError, ValueError):
        return False


PANDAS_INSTALLED = _installed("pandas")
MATPLOTLIB_INSTALLED = _installed("matplotlib")
SKLEARN_INSTALLED = _installed("sklearn")


def is_pandas_frame(data) -> bool:
    """A pandas DataFrame (duck-typed: no pandas import)."""
    return hasattr(data, "dtypes") and hasattr(data, "columns")


def sklearn_bases():
    """(model base, classifier mixin, regressor mixin, not-fitted error)
    for the scikit-learn estimators; stand-ins without scikit-learn."""
    if SKLEARN_INSTALLED:
        from sklearn.base import BaseEstimator, ClassifierMixin, RegressorMixin
        from sklearn.exceptions import NotFittedError

        class LGBMNotFittedError(NotFittedError):
            """Predicting with an unfitted estimator."""

        return BaseEstimator, ClassifierMixin, RegressorMixin, \
            LGBMNotFittedError

    class _Base:
        """Stand-in base when scikit-learn is absent."""

    class _Classifier:
        pass

    class _Regressor:
        pass

    class LGBMNotFittedError(ValueError, AttributeError):
        """Predicting with an unfitted estimator (an AttributeError too,
        so ``hasattr(est, "n_features_in_")`` is False before fit)."""

    return _Base, _Classifier, _Regressor, LGBMNotFittedError
