"""kernels.decode_attention: device ms a profiled tick of every kernel whose name holds ``decode_attention`` (the split pass and the combine pass); None without a trace or such a kernel."""


def read(rec):
    if rec.trace is None or not rec.trace["units"]:
        return None
    spent = [e - s for n, s, e in rec.trace["kernels"]
             if "decode_attention" in n]
    if not spent:
        return None
    return sum(spent) / len(rec.trace["units"]) / 1e3
