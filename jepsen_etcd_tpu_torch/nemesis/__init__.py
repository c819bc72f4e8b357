from .packages import nemesis_package, Nemesis

__all__ = ["nemesis_package", "Nemesis"]
