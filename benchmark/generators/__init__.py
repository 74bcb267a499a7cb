"""Traffic generators. A traffic file (``benchmark/traffic/<mix>.json``)
holds parameters and names, under ``generator``, the module here that
reads them; a mix of an existing generator is data alone.

A generator module defines ``Cell(conf, traffic, seed, device)``: one
cell's battle, built from its configuration file (``conf``), its traffic
parameters and the seed, with

- ``setup()``: everything before the window, which ``setup_s`` counts;
  ``split`` holds its parts (seconds, and counts);
- ``window(seconds) -> dict``: the measured window, with the readings the
  metrics' readers take (``frames``, ``wall_s``, ``call_s``,
  ``stepping``, ``order_s``, ``orders_attempted``, ``orders_failed``,
  ``cache_hits``, ``host_scope_ms``, ``cadences``, ``counters``,
  ``nav_stats``, ``events``, ``gc``);
- ``drive(frames) -> int``: the traffic for at least `frames` frames
  (the traced stretch);
- ``record(frames, rec)``: the traffic for `frames` frames more,
  recording each call of the timed path into a ``check.Recorder``;
- ``eng``, ``conf``, ``map_data``, ``device``, ``wave_log`` and
  ``formations`` (a ``check.FormationRecorder`` of set-up's auctions).

``contact.Cell`` is all of that for battles marched into contact and kept
there by reinforcement waves. A generator with other traffic subclasses
it and extends its hooks: ``prepare()`` (set-up after the march),
``before_call(n)`` and ``after_call(n)`` (around each call of the
engine's stepping, inside the timed frame).
"""
