"""Interactive REPL client for the text-generation server (mirror of
``megatron_llm_tpu/tools/text_generation_cli.py``; ``urllib``, no extra
dependencies).  Usage::

    python -m megatron_llm_tpu_torch.tools.text_generation_cli localhost:5000
"""

from __future__ import annotations

import json
import sys
import urllib.request


def put_request(url: str, body: dict, timeout: float = 300.0) -> dict:
    data = json.dumps(body).encode()
    req = urllib.request.Request(
        url, data=data, method="PUT",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print("usage: text_generation_cli HOST:PORT", file=sys.stderr)
        return 2
    url = argv[0]
    if not url.startswith("http"):
        url = "http://" + url
    url = url.rstrip("/") + "/api"
    while True:
        try:
            prompt = input("Enter prompt: ")
        except EOFError:
            return 0
        tokens = input("Enter number of tokens to generate: ")
        try:
            n = int(tokens)
        except ValueError:
            print("Number of tokens must be an integer, try again.")
            continue
        try:
            out = put_request(url, {"prompts": [prompt],
                                    "tokens_to_generate": n})
            print("Megatron Response:")
            print(out["text"][0])
        except Exception as e:  # noqa: BLE001 (a REPL survives a failure)
            print(f"request failed: {e}", file=sys.stderr)


if __name__ == "__main__":
    raise SystemExit(main())
