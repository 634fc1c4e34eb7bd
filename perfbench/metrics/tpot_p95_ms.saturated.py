"""p95 over the window's requests of a closed loop of (last token's
arrival - first token's arrival) / (new tokens - 1), in ms."""


def read(m):
    return m.tails.get("tpot_p95_ms")
