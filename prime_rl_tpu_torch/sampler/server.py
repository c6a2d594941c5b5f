"""HTTP serving for the sampling engine (the port of the JAX package's
``sampler/server.py``):

    POST /inference/v1/generate     token-in/out rollouts (+prompt_logprobs, VLM ``mm``)
    POST /v1/chat/completions       OpenAI-compatible chat (incl. SSE streaming)
    POST /v1/completions            OpenAI-compatible text completion
    GET  /v1/models                 model listing
    POST /abort /pause /resume      request cancel, drain-safe pause window
    POST /update_weights            load an HF snapshot, swap it in, bump the version
    GET  /liveness /health          probes
    GET  /metrics                   Prometheus text

Images ride the generate wire's ``mm`` for every vision family (the qwen3_vl
families and the hybrid qwen3_next_vl), as in the JAX package, whose chat
routes take none either. Constrained decoding: ``json_schema`` / ``regex`` in
the generate body (or ``guided_regex``), ``response_format`` (``json_schema``
or ``json_object``) and ``guided_regex`` on chat completions; a constraint the
engine cannot compile is answered 400. The P/D routes answer 501 until their
slice is ported. Built on aiohttp; the engine runs its own step-loop
thread and handlers await request futures.
"""

from __future__ import annotations

import asyncio
import json
import time
import uuid

from aiohttp import web

from prime_rl_tpu_torch.sampler.engine import Engine, EngineLoop, GenerationResult, SamplingParams
from prime_rl_tpu_torch.utils.logger import get_logger


def _sampling_from_body(body: dict, default_max_tokens: int = 512) -> SamplingParams:
    sp = body.get("sampling_params") or {}
    return SamplingParams(
        max_tokens=int(sp.get("max_tokens", default_max_tokens)),
        temperature=float(sp.get("temperature", 1.0)),
        top_p=float(sp.get("top_p", 1.0)),
        top_k=int(sp.get("top_k", -1)),
        stop_token_ids=list(sp.get("stop_token_ids", [])),
        logprobs=bool(sp.get("logprobs", True)),
        prompt_logprobs=bool(sp.get("prompt_logprobs", 0)),
        seed=sp.get("seed"),
        cache_salt=sp.get("cache_salt") or body.get("cache_salt"),
        adapter=sp.get("adapter") or body.get("lora_name"),
        json_schema=sp.get("json_schema") or body.get("json_schema"),
        regex=sp.get("regex") or body.get("guided_regex"),
    )


def _mm_from_body(body: dict):
    """VLM inputs on the generate wire: ``mm.pixel_values`` as either a
    nested list or ``{"b64": <base64 f32 LE>, "shape": [P, patch_dim]}``,
    plus ``mm.image_grid_thw`` [[t, h, w], ...] (HF-processor layout); None
    without ``mm``."""
    mm = body.get("mm")
    if not mm:
        return None
    import base64

    import numpy as np

    pv = mm["pixel_values"]
    if isinstance(pv, dict):
        arr = np.frombuffer(base64.b64decode(pv["b64"]), dtype="<f4").reshape(pv["shape"])
    else:
        arr = np.asarray(pv, np.float32)
    return {"pixel_values": arr,
            "image_grid_thw": np.asarray(mm["image_grid_thw"], np.int64)}


@web.middleware
async def _quiet_disconnects(request: web.Request, handler):
    """Per-request error isolation: a client that disconnects mid-request
    gets a quiet 499 (the engine-side abort already ran in ``_submit``); a
    feature that is not ported yet answers 501; any other handler error is
    reported in one log line and answered 500."""
    try:
        return await handler(request)
    except (asyncio.CancelledError, ConnectionResetError):
        return web.Response(status=499, text="client closed request")
    except web.HTTPException:
        raise
    except NotImplementedError as e:
        return web.json_response({"error": f"not implemented: {e}"}, status=501)
    except Exception as e:  # noqa: BLE001 — the server keeps serving
        get_logger().warning(f"request handler error: {request.path}: {type(e).__name__}: {e}")
        return web.json_response({"error": f"{type(e).__name__}: {e}"}, status=500)


class InferenceServer:
    def __init__(self, engine: Engine, model_name: str, tokenizer=None, role: str = "mixed"):
        self.engine = engine
        self.model_name = model_name
        self.tokenizer = tokenizer
        self.role = role  # P/D deployment role, exposed via /metrics
        if engine.token_bytes is None and tokenizer is not None:
            # constrained decoding needs vocab id -> bytes (the DFA and the
            # device tables are built on first use)
            from prime_rl_tpu_torch.sampler.constrain import token_bytes_from_tokenizer

            engine.token_bytes = token_bytes_from_tokenizer(tokenizer)
        self.loop_thread = EngineLoop(engine)
        self.app = web.Application(client_max_size=256 * 1024 * 1024,
                                   middlewares=[_quiet_disconnects])
        self.app.add_routes([
            web.post("/inference/v1/generate", self.generate),
            web.post("/v1/chat/completions", self.chat_completions),
            web.post("/v1/completions", self.completions),
            web.get("/v1/models", self.models),
            web.post("/abort", self.abort),
            web.post("/pause", self.pause),
            web.post("/resume", self.resume),
            web.post("/update_weights", self.update_weights),
            web.post("/load_lora_adapter", self.load_lora_adapter),
            web.post("/unload_lora_adapter", self.unload_lora_adapter),
            web.post("/pd/prefill", self.not_ported),
            web.post("/pd/inject", self.not_ported),
            web.get("/liveness", self.liveness),
            web.get("/health", self.liveness),
            web.get("/metrics", self.metrics),
        ])
        self._metrics = {"requests": 0, "tokens_generated": 0, "prompt_tokens": 0}

    async def _submit(self, prompt: list[int], sp: SamplingParams,
                      request_id: str | None = None, on_token=None,
                      mm: dict | None = None) -> GenerationResult:
        """Submit + await; a client disconnect / handler cancellation aborts
        the engine request instead of leaking a slot."""
        request_id = request_id or f"req-{uuid.uuid4().hex[:16]}"
        fut = self.engine.submit(prompt, sp, on_token=on_token, request_id=request_id, mm=mm)
        try:
            result = await asyncio.wrap_future(fut)
        except asyncio.CancelledError:
            self.engine.abort(request_id)
            raise
        except ValueError as e:
            if sp.constrained:  # a bad schema or regex, or a model that takes none
                raise web.HTTPBadRequest(text=f"constraint rejected: {e}") from e
            raise
        self._metrics["requests"] += 1
        self._metrics["tokens_generated"] += len(result.token_ids)
        self._metrics["prompt_tokens"] += result.prompt_len
        return result

    async def metrics(self, request: web.Request) -> web.Response:
        """Prometheus text exposition."""
        e = self.engine
        lines = [
            "# TYPE prime_rl_engine_info gauge",
            f'prime_rl_engine_info{{role="{self.role}"}} 1',
            "# TYPE prime_rl_engine_requests_total counter",
            f"prime_rl_engine_requests_total {self._metrics['requests']}",
            "# TYPE prime_rl_engine_generation_tokens_total counter",
            f"prime_rl_engine_generation_tokens_total {self._metrics['tokens_generated']}",
            "# TYPE prime_rl_engine_prompt_tokens_total counter",
            f"prime_rl_engine_prompt_tokens_total {self._metrics['prompt_tokens']}",
            "# TYPE prime_rl_engine_active_requests gauge",
            f"prime_rl_engine_active_requests {len(e.active)}",
            "# TYPE prime_rl_engine_pending_requests gauge",
            f"prime_rl_engine_pending_requests {len(e.pending)}",
            "# TYPE prime_rl_engine_free_kv_pages gauge",
            f"prime_rl_engine_free_kv_pages {e.slots.alloc.num_free}",
            "# TYPE prime_rl_engine_policy_version gauge",
            f"prime_rl_engine_policy_version {e.policy_version}",
        ]
        for k, v in e.stats.items():
            lines += [f"# TYPE prime_rl_engine_{k}_total counter",
                      f"prime_rl_engine_{k}_total {v}"]
        return web.Response(text="\n".join(lines) + "\n", content_type="text/plain")

    # -- inference routes ---------------------------------------------------

    async def generate(self, request: web.Request) -> web.Response:
        body = await request.json()
        token_ids = body.get("token_ids")
        if token_ids is None:
            raise web.HTTPBadRequest(text="token_ids required")
        sp = _sampling_from_body(body)
        result = await self._submit(token_ids, sp, request_id=body.get("request_id"),
                                    mm=_mm_from_body(body))
        # prompt_logprobs wire format: one entry per prompt token, None for the
        # leading token, {token_id: {logprob}} else
        plp = None
        if result.prompt_logprobs is not None:
            plp = [None] + [
                {str(tok): {"logprob": lp}}
                for tok, lp in zip(token_ids[1:], result.prompt_logprobs[1:])
            ]
        return web.json_response({
            "request_id": f"gen-{uuid.uuid4().hex[:16]}",
            "choices": [{
                "index": 0,
                "token_ids": result.token_ids,
                "logprobs": result.logprobs if sp.logprobs else None,
                "finish_reason": result.finish_reason,
                "routed_experts": (result.routed_experts.tolist()
                                   if result.routed_experts is not None else None),
            }],
            "prompt_logprobs": plp,
            "usage": {
                "prompt_tokens": result.prompt_len,
                "completion_tokens": len(result.token_ids),
                "total_tokens": result.prompt_len + len(result.token_ids),
            },
            "policy_version": result.policy_version,
        })

    async def chat_completions(self, request: web.Request) -> web.Response:
        if self.tokenizer is None:
            raise web.HTTPServiceUnavailable(text="no tokenizer loaded")
        body = await request.json()
        prompt = self.tokenizer.apply_chat_template(
            body["messages"], tokenize=True, add_generation_prompt=True)
        model = body.get("model")
        # OpenAI response_format: {"type": "json_schema", "json_schema":
        # {"schema": {...}}} or {"type": "json_object"} -> DFA-constrained
        # sampling (sampler/constrain.py)
        schema = None
        regex = body.get("guided_regex")
        rf = body.get("response_format") or {}
        if rf.get("type") == "json_schema":
            schema = (rf.get("json_schema") or {}).get("schema") or rf.get("schema")
            if schema is None:
                raise web.HTTPBadRequest(text="response_format.json_schema.schema missing")
        elif rf.get("type") == "json_object":
            # a JSON object nested at most 2 deep (a regular language cannot
            # express unbounded nesting)
            from prime_rl_tpu_torch.sampler.constrain import json_object_regex

            regex = json_object_regex()
        sp = SamplingParams(
            max_tokens=int(body.get("max_tokens") or body.get("max_completion_tokens") or 512),
            temperature=float(body.get("temperature", 1.0)),
            top_p=float(body.get("top_p", 1.0)),
            seed=body.get("seed"),
            adapter=model if model in self.engine.adapters else None,
            json_schema=schema,
            regex=regex,
        )
        if body.get("stream"):
            return await self._stream_chat(request, body, prompt, sp)
        result = await self._submit(prompt, sp)
        completion_ids = result.token_ids
        if completion_ids and completion_ids[-1] == self.engine.spec.eos_token_id:
            completion_ids = completion_ids[:-1]
        logprobs_payload = None
        if body.get("logprobs"):
            logprobs_payload = {"content": [
                {"token": self.tokenizer.decode([t]), "logprob": lp, "top_logprobs": []}
                for t, lp in zip(result.token_ids, result.logprobs)
            ]}
        return web.json_response({
            "id": f"chatcmpl-{uuid.uuid4().hex[:16]}",
            "object": "chat.completion",
            "created": int(time.time()),
            "model": body.get("model", self.model_name),
            "choices": [{
                "index": 0,
                "message": {"role": "assistant",
                            "content": self.tokenizer.decode(completion_ids)},
                "logprobs": logprobs_payload,
                "finish_reason": result.finish_reason,
            }],
            "usage": {
                "prompt_tokens": result.prompt_len,
                "completion_tokens": len(result.token_ids),
                "total_tokens": result.prompt_len + len(result.token_ids),
            },
        })

    async def _stream_chat(self, request: web.Request, body: dict,
                           prompt: list[int], sp: SamplingParams) -> web.StreamResponse:
        """SSE streaming chat completion (OpenAI wire format)."""
        loop = asyncio.get_running_loop()
        queue: asyncio.Queue = asyncio.Queue()

        def on_token(token: int, logprob: float) -> None:
            loop.call_soon_threadsafe(queue.put_nowait, token)

        resp = web.StreamResponse(headers={"Content-Type": "text/event-stream",
                                           "Cache-Control": "no-cache"})
        await resp.prepare(request)
        cid = f"chatcmpl-{uuid.uuid4().hex[:16]}"
        model = body.get("model", self.model_name)
        eos = self.engine.spec.eos_token_id

        def chunk(delta: dict, finish: str | None = None) -> bytes:
            payload = {
                "id": cid, "object": "chat.completion.chunk",
                "created": int(time.time()), "model": model,
                "choices": [{"index": 0, "delta": delta, "finish_reason": finish}],
            }
            return f"data: {json.dumps(payload)}\n\n".encode()

        await resp.write(chunk({"role": "assistant"}))
        result_task = asyncio.ensure_future(self._submit(prompt, sp, on_token=on_token))
        while True:
            get = asyncio.ensure_future(queue.get())
            done, _ = await asyncio.wait({get, result_task}, return_when=asyncio.FIRST_COMPLETED)
            if get in done:
                token = get.result()
                if token != eos:
                    await resp.write(chunk({"content": self.tokenizer.decode([token])}))
                continue
            get.cancel()
            while not queue.empty():
                token = queue.get_nowait()
                if token != eos:
                    await resp.write(chunk({"content": self.tokenizer.decode([token])}))
            result = result_task.result()
            await resp.write(chunk({}, finish=result.finish_reason))
            await resp.write(b"data: [DONE]\n\n")
            break
        await resp.write_eof()
        return resp

    async def completions(self, request: web.Request) -> web.Response:
        if self.tokenizer is None:
            raise web.HTTPServiceUnavailable(text="no tokenizer loaded")
        body = await request.json()
        prompt_ids = self.tokenizer(body["prompt"])["input_ids"]
        sp = SamplingParams(
            max_tokens=int(body.get("max_tokens", 16)),
            temperature=float(body.get("temperature", 1.0)),
            top_p=float(body.get("top_p", 1.0)),
            seed=body.get("seed"),
        )
        result = await self._submit(prompt_ids, sp)
        return web.json_response({
            "id": f"cmpl-{uuid.uuid4().hex[:16]}",
            "object": "text_completion",
            "created": int(time.time()),
            "model": body.get("model", self.model_name),
            "choices": [{
                "index": 0,
                "text": self.tokenizer.decode(result.token_ids),
                "finish_reason": result.finish_reason,
            }],
            "usage": {
                "prompt_tokens": result.prompt_len,
                "completion_tokens": len(result.token_ids),
                "total_tokens": result.prompt_len + len(result.token_ids),
            },
        })

    async def models(self, request: web.Request) -> web.Response:
        return web.json_response({
            "object": "list",
            "data": [{"id": self.model_name, "object": "model", "owned_by": "prime-rl-tpu"}],
        })

    # -- admin routes -------------------------------------------------------

    async def abort(self, request: web.Request) -> web.Response:
        body = await request.json()
        rid = body.get("request_id")
        if rid is None:
            raise web.HTTPBadRequest(text="request_id required")
        ok = self.engine.abort(str(rid))
        return web.json_response({"status": "ok" if ok else "not_found"})

    async def pause(self, request: web.Request) -> web.Response:
        self.engine.pause()
        return web.json_response({"status": "paused"})

    async def resume(self, request: web.Request) -> web.Response:
        self.engine.resume()
        return web.json_response({"status": "running"})

    async def update_weights(self, request: web.Request) -> web.Response:
        """Body ``{"weight_dir": <HF snapshot dir>, "version": N}``: the
        filesystem weight plane's apply step. The snapshot loads onto the
        engine's device in an executor, off the engine's lock; the swap then
        waits for the step in flight (the caller pauses around it)."""
        body = await request.json()
        weight_dir = body.get("weight_dir")
        version = body.get("version")
        if weight_dir is None:
            raise web.HTTPBadRequest(text="weight_dir required")
        t0 = time.perf_counter()
        engine = self.engine

        def load():
            from prime_rl_tpu_torch.models.qwen3 import load_hf_weights

            return load_hf_weights(weight_dir, engine.spec, dtype=engine.compute_dtype,
                                   device=engine.device)

        params = await asyncio.get_running_loop().run_in_executor(None, load)
        engine.update_params(params, version=version)
        get_logger().info(f"updated weights from {weight_dir} (v{version}) in "
                          f"{time.perf_counter() - t0:.1f}s")
        return web.json_response({"status": "ok", "version": version})

    async def load_lora_adapter(self, request: web.Request) -> web.Response:
        """Install a PEFT-style adapter into the serving bank. Body:
        ``{"lora_name": ..., "lora_path": <dir or .safetensors>}``; the file
        is read on a worker thread (``models/lora.load_adapter_file``)."""
        if self.engine.lora_config is None:
            return web.json_response(
                {"error": "server started without inference.lora config"}, status=501)
        body = await request.json()
        name, path = body.get("lora_name"), body.get("lora_path")
        if not name or not path:
            raise web.HTTPBadRequest(text="lora_name and lora_path required")
        from prime_rl_tpu_torch.models.lora import load_adapter_file

        try:
            layers = await asyncio.get_running_loop().run_in_executor(
                None, load_adapter_file, path, self.engine.spec)
            self.engine.pause()
            try:
                self.engine.load_adapter(str(name), layers)
            finally:
                self.engine.resume()
        except (ValueError, RuntimeError, FileNotFoundError) as e:
            return web.json_response({"error": str(e)}, status=400)
        get_logger().info(f"loaded LoRA adapter {name!r} from {path}")
        return web.json_response({"status": "ok", "adapters": sorted(self.engine.adapters)})

    async def unload_lora_adapter(self, request: web.Request) -> web.Response:
        body = await request.json()
        name = body.get("lora_name")
        if not name:
            raise web.HTTPBadRequest(text="lora_name required")
        ok = self.engine.unload_adapter(str(name)) if self.engine.lora_config else False
        return web.json_response({"status": "ok" if ok else "not_found"})

    async def not_ported(self, request: web.Request) -> web.Response:
        return web.json_response(
            {"error": f"{request.path} is not ported to this package yet"}, status=501)

    async def liveness(self, request: web.Request) -> web.Response:
        return web.json_response({
            "status": "ok",
            "active": len(self.engine.active),
            "pending": len(self.engine.pending),
            "paused": self.engine.paused,
            "policy_version": self.engine.policy_version,
        })

    # -- lifecycle ----------------------------------------------------------

    def run(self, host: str = "0.0.0.0", port: int = 8000) -> None:
        self.loop_thread.start()
        try:
            web.run_app(self.app, host=host, port=port, print=None)
        finally:
            self.loop_thread.stop()

    async def start_async(self, host: str, port: int) -> web.AppRunner:
        """Start the engine loop and serve on ``host:port`` inside the running
        event loop; stop with ``stop_async(runner)``."""
        self.loop_thread.start()
        runner = web.AppRunner(self.app)
        await runner.setup()
        await web.TCPSite(runner, host, port).start()
        return runner

    async def stop_async(self, runner: web.AppRunner) -> None:
        await runner.cleanup()
        self.loop_thread.stop()
