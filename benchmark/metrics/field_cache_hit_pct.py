"""The nav service's field cache over the window's player orders:
``NavService.stats`` hits over hits and misses counted across each
order."""


def read(m):
    hits, misses = m["window"]["cache_hits"]
    if hits + misses == 0:
        return None
    return 100.0 * hits / (hits + misses)
