"""p95 of the time to first streamed tokens from each request's send,
over the window's requests of a closed loop, in ms."""


def read(m):
    return m.tails.get("ttft_p95_ms")
