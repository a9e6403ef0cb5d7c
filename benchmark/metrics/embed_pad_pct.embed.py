"""The share of the encoder's [height x bucket] slots that carry no token
(%): 100 x (1 - ``embed.tokens`` / ``embed.token_slots``) over the window."""


def read(ctx):
    c = ctx["delta"]["counters"]
    slots = c.get("embed.token_slots", 0.0)
    return 100.0 * (1.0 - c.get("embed.tokens", 0.0) / slots) if slots > 0 else None
