"""The yardstick of the DHT benchmark: manifest, run loop, trace reading.

Everything that belongs to one configuration, traffic mix, per-layer
metric or kernel lives in a file of its own under ``dhtbench/`` and is
found by the name ``BENCHMARK.json`` gives it (``dhtb.manifest``).
"""
