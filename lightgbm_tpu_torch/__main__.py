"""CLI entry: ``python -m lightgbm_tpu_torch config=train.conf
[key=value ...]`` (counterpart of ``lightgbm_tpu/__main__.py``).

reference: src/main.cpp:11.
"""
from .application import main

if __name__ == "__main__":
    main()
