"""The smallest SDK pipeline: Frontend -> Middle -> Backend.

The port's copy of ``examples/hello_world/hello_world.py`` (reference:
upstream examples/hello_world/hello_world.py, a three-service graph that
splits, upper-cases and decorates a prompt; no model, no card). Serve it:

    python -m dynamo_tpu_torch.runtime.transports.dynstore --port 4871 &
    python -m dynamo_tpu_torch.sdk.worker \\
        dynamo_tpu_torch.examples.hello_world:Frontend --service Backend \\
        --store-port 4871 &
    ... (or GraphSupervisor to spawn all three)
"""

from dynamo_tpu_torch.sdk import depends, dynamo_endpoint, service


@service(dynamo={"namespace": "hello"})
class Backend:
    @dynamo_endpoint
    async def generate(self, request):
        for word in request["text"].split(","):
            yield {"text": f"back-{word.strip()}"}


@service(dynamo={"namespace": "hello"})
class Middle:
    backend = depends(Backend)

    @dynamo_endpoint
    async def generate(self, request):
        async for item in self.backend.generate(request):
            yield {"text": f"mid-{item['text']}"}


@service(dynamo={"namespace": "hello"})
class Frontend:
    middle = depends(Middle)

    @dynamo_endpoint
    async def generate(self, request):
        async for item in self.middle.generate(request):
            yield {"text": f"front-{item['text']}"}


Frontend.link(Middle).link(Backend)
