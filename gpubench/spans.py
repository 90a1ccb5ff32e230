"""The traced run's spans: calls into the program's layers wrapped, from the
benchmark's side, in intervals of the host's clock, kept as (start_ns,
end_ns, name). The clock is the one the profiler stamps its device events
with (Unix time in nanoseconds, `time.time_ns`), so the spans and the
kernels lie on one timeline without the profiler recording host
operations. Nothing in the program is edited: each wrapper replaces an
attribute (a module's function, a class's method or an instance's) for the
traced run and is put back afterwards. The untraced run wraps nothing."""

import functools
from time import time_ns


class Spans:
    def __init__(self):
        self._patched = []
        self.intervals = []  # (start_ns, end_ns, name), in the order they end

    def wrap(self, owner, attr, name, before=None, after=None):
        """Replace owner.attr with a span of `name` around it. `before(args,
        kwargs)` and `after(result, args, kwargs)` run inside the span."""
        inner = getattr(owner, attr)
        intervals = self.intervals

        @functools.wraps(inner)
        def wrapper(*args, **kwargs):
            start = time_ns()
            if before is not None:
                before(args, kwargs)
            result = inner(*args, **kwargs)
            if after is not None:
                after(result, args, kwargs)
            intervals.append((start, time_ns(), name))
            return result

        had_own = attr in getattr(owner, "__dict__", {})
        self._patched.append((owner, attr, inner, had_own))
        setattr(owner, attr, wrapper)
        return wrapper

    def restore(self):
        while self._patched:
            owner, attr, inner, had_own = self._patched.pop()
            if had_own:
                setattr(owner, attr, inner)
            else:
                delattr(owner, attr)
