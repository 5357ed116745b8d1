"""Logging initialisation (port of ``glomargridding_tpu/utils/logging.py``)."""

import logging


def _get_logging_level(level: str) -> int:
    match level.lower():
        case "debug":
            return 10
        case "info":
            return 20
        case "warn":
            return 30
        case "error":
            return 40
        case "critical":
            return 50
        case _:
            raise ValueError(f"Unknown logging level: {level}")


def init_logging(file: str | None = None, level: str = "DEBUG") -> None:
    """Configure stdlib logging to a file or stdout and capture warnings."""
    from importlib import reload

    level_i = _get_logging_level(level)
    reload(logging)
    logging.basicConfig(
        filename=file,
        filemode="a",
        encoding="utf-8",
        format="%(levelname)s at %(asctime)s : %(message)s",
        level=level_i,
    )
    logging.captureWarnings(True)
