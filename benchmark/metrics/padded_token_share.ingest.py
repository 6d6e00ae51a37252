"""Real tokens over the tokens of the padded batches the embedder ran in
the ingest window, %. An ingest window in which the embedder showed no
padded batch fails the run, so the count cannot drop out of the line."""


def read(run):
    if run.kind != "ingest":
        return None
    if not run.padded_tokens:
        raise RuntimeError("padded_token_share.ingest: the embedder showed no padded batch "
                           "in the window (MiniLMEmbedder.encode_padded not called)")
    return 100.0 * run.real_tokens / run.padded_tokens
