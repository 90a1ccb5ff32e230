"""Host time a move outside the move loop: play() minus its play_chunk
(timed to a device synchronize), the host's cut of each lane's records
into episodes, over the traced run's unprofiled calls. Spans: the
benchmark's host clock around play() and play_chunk."""


def read(r):
    calls = [c for c in r["calls"] if not c["profiled"] and c.get("chunk_s") is not None]
    if not calls:
        return None
    moves = sum(c["moves"] for c in calls)
    return 1e3 * sum(c["wall_s"] - c["chunk_s"] for c in calls) / moves
