"""The window's share with no encoder work queued (%): ``embed.starved``
(from one ``encode_texts`` call's last fetch to the next call's first
launch) over the window."""


def read(ctx):
    t = ctx["delta"]["timers"].get("embed.starved")
    if not t or t["count"] <= 0 or ctx["window_s"] <= 0:
        return None
    return 100.0 * t["total_s"] / ctx["window_s"]
