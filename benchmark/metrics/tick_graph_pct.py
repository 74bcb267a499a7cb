"""The share of the window's frames the engine stepped as segments of its
scan stepper (a CUDA graph replay each on the card): ``Engine.counters``'
``tick.graph_frames`` over it and ``tick.eager_frames``, in %. None where
the program has neither counter or stepped no frame."""


def read(m):
    c = m["window"]["counters"]
    if "tick.graph_frames" not in c and "tick.eager_frames" not in c:
        return None
    graph = c.get("tick.graph_frames", 0.0)
    total = graph + c.get("tick.eager_frames", 0.0)
    return 100.0 * graph / total if total > 0 else None
