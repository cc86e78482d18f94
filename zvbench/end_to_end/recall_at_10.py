"""recall_at_10: the share of returned ids, over every query answered in the
run, that are among the reference's exact 10 nearest rows."""
UNIT = "fraction"


def read(rec):
    if rec.get("k") != 10 or rec.get("recall") is None:
        return None
    return rec["recall"]
