"""A stepped clock for the port's tests (the spelling of the JAX suite's
``tests/unit/_fake_clock.py`` ``TickClock``, kept here so the port's tests
do not import the JAX suite's helpers): each read advances it by ``dt``,
and ``advance(s)`` steps it by ``s`` at once."""


class TickClock:
    def __init__(self, dt=0.001):
        self.t = 0.0
        self.dt = dt

    def __call__(self):
        self.t += self.dt
        return self.t

    def advance(self, s):
        self.t += s
