"""Component registry for YAML-driven pipeline composition.

The reference composes its whole pipeline from YAML ``{type: <name>, args: {...}}``
nodes resolved through a subclass registry (reference:
Utility/Extensions/SubclassRegistry.py:8-48). We keep the behavioral contract —
every pluggable interface can instantiate any registered implementation by name —
but use an explicit per-interface registry dict populated by ``__init_subclass__``,
which also lets tests enumerate implementations without import-order tricks.
"""

from __future__ import annotations

from typing import Any, Callable, ClassVar, TypeVar

T = TypeVar("T", bound="Registered")


class Registered:
    """Mixin: every concrete subclass is recorded under its class name.

    ``IFoo.instantiate("Bar", args)`` builds the implementation from a config
    node. Abstract intermediate classes may opt out with ``register=False``.
    """

    _registry: ClassVar[dict[str, type]]

    def __init_subclass__(cls, register: bool = True, **kwargs: Any) -> None:
        super().__init_subclass__(**kwargs)
        # Each direct child of a root mixin (Registered / RegisteredConfigTestable)
        # opens a fresh registry namespace; deeper subclasses join their parent's.
        roots = {Registered}
        rct = globals().get("RegisteredConfigTestable")
        if rct is not None:
            roots.add(rct)
        if roots & set(cls.__bases__):
            cls._registry = {}
        if register and hasattr(cls, "_registry"):
            cls._registry[cls.__name__] = cls

    @classmethod
    def name(cls) -> str:
        return cls.__name__

    @classmethod
    def registered(cls) -> dict[str, type]:
        return dict(cls._registry)

    @classmethod
    def get_class(cls: type[T], type_name: str) -> type[T]:
        try:
            return cls._registry[type_name]
        except KeyError:
            raise KeyError(
                f"{cls.__name__}: no registered implementation named {type_name!r}; "
                f"known: {sorted(cls._registry)}"
            ) from None

    @classmethod
    def instantiate(cls: type[T], type_name: str, *args: Any, **kwargs: Any) -> T:
        return cls.get_class(type_name)(*args, **kwargs)


class ConfigTestable:
    """Config pre-flight validation (reference: Utility/Extensions/Testable.py:9-40).

    Implementations declare ``is_valid_config`` so an entire experiment config
    tree can be checked without loading weights or data.
    """

    @classmethod
    def is_valid_config(cls, config: Any) -> None:
        raise NotImplementedError

    @classmethod
    def _enforce_config_spec(cls, config: Any, spec: dict[str, Callable[[Any], bool]]) -> None:
        """Each spec entry maps an attribute name to a predicate on its value."""
        if config is None:
            if not spec:
                return  # bare `args:` yaml node with no required keys
            raise ValueError(f"{cls.__name__}: config is None but spec expects {sorted(spec)}")
        for key, predicate in spec.items():
            if not hasattr(config, key):
                raise ValueError(f"{cls.__name__}: config missing key '{key}'")
            value = getattr(config, key)
            ok = predicate(value)
            if not ok:
                raise ValueError(f"{cls.__name__}: config key '{key}' has invalid value {value!r}")


class RegisteredConfigTestable(Registered, ConfigTestable, register=False):
    """Common base for pipeline interfaces: registry + config validation.

    ``is_valid_config`` on the interface dispatches to the subclass named by
    ``config.type`` (reference: Utility/Extensions/__init__.py:9-16).
    """

    @classmethod
    def is_valid_config(cls, config: Any) -> None:
        if config is None or not hasattr(config, "type"):
            raise ValueError(f"{cls.__name__}: config must have a 'type' field, got {config!r}")
        impl = cls.get_class(config.type)
        impl.is_valid_config(getattr(config, "args", None))
