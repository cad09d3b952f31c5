"""Attribute-style state containers (API parity with reference
gibbs/state.py).

The samplers carry their hot-loop state as plain dicts of batched
tensors, so these classes are *user-facing*
conveniences: ``State`` wraps a sampler state for attribute access and
``FixedState`` is the write-once variant the reference uses for
configuration containers (behavior contract: reference gibbs/state.py,
rewritten here over an explicit dict rather than SimpleNamespace).
"""


class BaseStorage:
    """Dict-backed namespace: attributes and items address one store."""

    def __init__(self, **entries):
        object.__setattr__(self, '_entries', dict(entries))

    def __getattr__(self, name):
        # fetch the store without re-entering __getattr__: during
        # unpickling/deepcopy the protocol probes dunder attributes
        # (e.g. __setstate__) before __init__ has run, when _entries
        # does not exist yet — self._entries here would recurse forever
        try:
            entries = object.__getattribute__(self, '_entries')
        except AttributeError:
            raise AttributeError(name) from None
        try:
            return entries[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name, value):
        self._entries[name] = value

    def __getitem__(self, name):
        return self._entries[name]

    def __repr__(self):
        body = ', '.join(f'{k}={v!r}' for k, v in self._entries.items())
        return f'{type(self).__name__}({body})'

    def __eq__(self, other):
        return (
            type(other) is type(self) and other._entries == self._entries
        )


class State(BaseStorage):
    """Mutable parameter namespace; iterates over parameter names."""

    def __iter__(self):
        return iter(self._entries)

    def as_dict(self):
        """The underlying pytree-compatible dict (a copy)."""
        return dict(self._entries)


class FixedState(BaseStorage):
    """Write-once storage for quantities that stay constant during
    sampling; rebinding a name raises ``KeyError`` (the reference's
    contract for its configuration containers)."""

    def __setattr__(self, name, value):
        if name in self._entries:
            raise KeyError('cannot change attributes already set')
        super().__setattr__(name, value)
