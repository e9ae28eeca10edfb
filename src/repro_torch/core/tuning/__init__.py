"""Measured-cost calibration on the card (the port's copy of
``repro.core.tuning``).

Closes the loop between what the cost models *assume* and what the executor
*measures*:

* ``profile``   — :class:`Profiler`/:class:`Profile`: per-block wall-time
  capture keyed ``(backend, signature)``, JSON persistence with cost-model
  registry-version staleness checks;
* ``calibrate`` — least-squares fit of per-backend dispatch overhead and
  per-byte prices; ``install_fit`` publishes the fit that
  ``make_cost_model("calibrated")`` (``core.cost``) prices partition
  merges and lowering decisions with.

Quickstart::

    from repro_torch.core.tuning import calibrate
    fit = calibrate(save="profile.json")     # measure + fit + install
    # ... Runtime(cost_model="calibrated") now prices measured reality

    from repro_torch.core.tuning import load_and_install
    load_and_install("profile.json")         # warm process: reuse the fit
"""

from .calibrate import (CalibratedFit, calibrate, clear_fit,   # noqa: F401
                        current_epoch, current_fit, fit_profile,
                        install_fit, load_and_install)
from .profile import (Profile, Profiler, ProfileSample,        # noqa: F401
                      StaleProfileError, signature_digest)
