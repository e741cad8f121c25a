"""The tuner on a 6-parameter quadratic with a known optimum.

The port of examples/tune_quadratic.py, on the port's own tuner
(offt_tpu_torch/tune/): Active Harmony's canonical example (minimum at
(15, 30, 45, 60, 75, 90) over [1, 100], about 200 trials). The objective
is evaluated on the host; ``--device`` is checked like every example's
(the default, ``cuda``, needs a card), and nothing runs on it.

Run:  python examples_torch/tune_quadratic.py [strategy] [--device cpu]
"""

from __future__ import annotations

from _common import device, parser

from offt_tpu_torch.tune.synth import AH_OPTIMUM, ah_quadratic, \
    quadratic_space
from offt_tpu_torch.tune.tuner import Tuner


def search(strategy: str = "nm", trials: int = 200, seed: int = 0):
    """(best point, its value, trials run, converged)."""
    tuner = Tuner(quadratic_space(), objective=ah_quadratic,
                  strategy=strategy, max_trials=trials, seed=seed)
    best, perf = tuner.run()
    return best, perf, len(tuner.trials), tuner.strategy.converged()


def main(argv=None) -> int:
    ap = parser(__doc__, trials=200)
    ap.add_argument("strategy", nargs="?", default="nm")
    ns = ap.parse_args(argv)
    device(ns.device)
    best, perf, n, conv = search(ns.strategy, ns.trials)
    print(f"strategy={ns.strategy} best={best} perf={perf} "
          f"(optimum {AH_OPTIMUM} -> 0)")
    print(f"trials: {n}  converged: {conv}")
    print("OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
