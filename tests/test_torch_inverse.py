"""The inverse-rendering trainer of spt_tpu_torch:
``examples/inverse_albedo_torch.py`` and its gradient step
``integrators/megakernel.GradStep`` (the counterpart of
``jax.jit(jax.grad(loss_fn))``).

On the CPU: ``GradStep`` runs its body eagerly and equals
``torch.autograd.grad`` of the same loss bit for bit, loss and gradient,
on two calls with the parameter changed in place between them; the port's
training loop against the JAX example's (``jax.value_and_grad`` of the
JAX megakernel's image MSE, eager as tests/test_torch_megakernel.py takes
it, and ``optax.adam(0.05)`` with the clip), 5 steps at 32x16 d3 from the
same 0.5 start: the hidden materials (zero gradient) stay exactly 0.5 in
both, the visible entries agree within 1e-3 after every step (Adam
normalizes the gradient, so an entry moves by about the learning rate a
step whatever the gradient's size; 1e-3 is 2 % of one step), the losses at
rtol 1e-3 (the gate of the megakernel's gradient against ``jax.grad``);
``main(steps=2, device="cpu")`` prints the JAX example's lines.

On the card (``cuda`` marker): the captured step against the eager body
(two eager gradients agree bit for bit on the card, so the captured one is
held bit for bit too), one graph launch a call; a capture that raises (a
loss that reads the device from the host) raises again at the next call
and leaves the stream usable; the parameter and the returned buffers keep
their addresses across steps and optimizer updates.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import chip_smoke  # noqa: E402
from spt_tpu_torch.config import RenderConfig  # noqa: E402
from spt_tpu_torch.integrators import megakernel as tmk  # noqa: E402
from spt_tpu_torch.integrators import wavefront as twf  # noqa: E402

CPU = torch.device("cpu")
ex = chip_smoke.trainer_module()


def _problem(w, h, depth, device=CPU):
    cfg = RenderConfig(width=w, height=h, spp=1, max_depth=depth)
    return ex.albedo_loss(*ex.example_inputs(device, cfg))


def _same(a, b):
    """Bit for bit: float tensors compared as their int32 words."""
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.view(torch.int32), b.view(torch.int32)))


def test_grad_step_is_autograd_grad_bit_for_bit():
    loss_fn, true_bc = _problem(16, 8, 3)
    step = tmk.GradStep(loss_fn, torch.full_like(true_bc, 0.5))
    assert step.param.is_leaf and step.param.requires_grad
    for change in (None, lambda p: p.mul_(0.7).add_(0.2 * true_bc)):
        if change is not None:
            with torch.no_grad():
                change(step.param)
        p = step.param.detach().clone().requires_grad_(True)
        want_loss = loss_fn(p)
        (want_grad,) = torch.autograd.grad(want_loss, p)
        loss, grad = step()
        assert loss is step.loss and grad is step.grad
        assert _same(loss, want_loss.detach()) and _same(grad, want_grad)
        assert not loss.requires_grad and not grad.requires_grad
    assert (step.grad != 0).sum() >= 6


def test_training_matches_jax_grad_and_optax_adam():
    jax = pytest.importorskip("jax")
    optax = pytest.importorskip("optax")
    import jax.numpy as jnp

    from spt_tpu import camera as jcamera
    from spt_tpu import config as jconfig
    from spt_tpu import env as jenv
    from spt_tpu import lights as jlights
    from spt_tpu import scene as jscene
    from spt_tpu.integrators import megakernel as jmk

    w, h, depth, steps = 32, 16, 3, 5
    cfg, scene, env, lights, cam = ex.example_inputs(
        CPU, RenderConfig(width=w, height=h, spp=1, max_depth=depth))
    jcfg = jconfig.RenderConfig(width=w, height=h, spp=1, max_depth=depth)
    jsc = jscene.flatten_scene(jscene.build_default_scene())
    jenv_, jl = jenv.make_procedural_environment(), jlights.default_lights()
    jcam = jcamera.default_camera(w, h).rays()
    # both packages' builders give the same material tables
    for f in scene.materials._fields:
        np.testing.assert_array_equal(
            getattr(scene.materials, f).numpy(),
            np.asarray(getattr(jsc.materials, f)), err_msg=f)

    def jrender(bc):
        s = jsc._replace(materials=jsc.materials._replace(base_color=bc))
        return jmk.render_sample(jcfg, s, jenv_, jl, jcam, 0)

    true_bc = jsc.materials.base_color
    target = jrender(true_bc)
    value_and_grad = jax.value_and_grad(
        lambda bc: jnp.mean((jrender(bc) - target) ** 2))
    opt = optax.adam(0.05)
    bc = jnp.full_like(true_bc, 0.5)
    opt_state = opt.init(bc)
    jax_losses, jax_bcs, hidden = [], [], None
    for i in range(steps):
        loss, g = value_and_grad(bc)
        if hidden is None:
            hidden = np.asarray(g == 0).all(axis=1)
        updates, opt_state = opt.update(g, opt_state)
        bc = jnp.clip(optax.apply_updates(bc, updates), 0.0, 1.0)
        jax_losses.append(float(loss))
        jax_bcs.append(np.asarray(bc))

    loss_fn, port_true = ex.albedo_loss(cfg, scene, env, lights, cam)
    assert hidden.sum() >= 1 and (~hidden).sum() >= 6
    for k in range(1, steps + 1):
        # a run of k steps from the 0.5 start: the parameter after step k
        trained = ex.train(loss_fn, port_true, steps=k, log=lambda *_: None)
        got = trained.step.param.detach().numpy()
        want = jax_bcs[k - 1]
        assert (got[hidden] == 0.5).all() and (want[hidden] == 0.5).all()
        np.testing.assert_allclose(got[~hidden], want[~hidden], rtol=0,
                                   atol=1e-3, err_msg=f"after step {k}")
    np.testing.assert_allclose(trained.losses.numpy(), jax_losses, rtol=1e-3)
    assert (trained.seen == ~hidden).all()


def test_example_main_runs_on_the_cpu(capsys):
    err = ex.main(steps=2, device="cpu")
    out = capsys.readouterr().out.splitlines()
    # the JAX example prints 4.415e-04 after its first step
    assert out[0] == "step    0  image MSE 4.415e-04"
    assert out[1].startswith("step    1  image MSE ")
    assert out[2].startswith("visible materials: 7/9, max albedo error "
                             "after 2 steps: ")
    assert np.isfinite(err) and 0 < err < 1


# --- on the card -----------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the captured gradient step is a "
                    "CUDA graph")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_captured_step_is_the_eager_body_on_card(cuda_device):
    loss_fn, true_bc = _problem(64, 32, 3, cuda_device)
    step = tmk.GradStep(loss_fn, torch.full_like(true_bc, 0.5))
    eager = [tuple(t.clone() for t in step.body()) for _ in range(2)]
    assert all(_same(a, b) for a, b in zip(*eager))
    for _ in range(2):
        loss, grad = step()
        assert _same(loss, eager[0][0]) and _same(grad, eager[0][1])
    assert step.graph.launches == 2
    # the same as the CPU's gradient within phase 21's tolerance
    cpu_loss, cpu_true = _problem(64, 32, 3)
    _, g_cpu = tmk.GradStep(cpu_loss, torch.full_like(cpu_true, 0.5))()
    assert chip_smoke.grads_agree(torch, grad.cpu(), g_cpu)[1]


@pytest.mark.cuda
def test_a_capture_that_raises_raises_again(cuda_device):
    x = torch.ones(3, device=cuda_device)

    def reads_the_device(p):
        loss = (p * x).sum()
        if float(loss.detach()) > 1e30:  # a host read: no capture takes it
            loss = loss * 0
        return loss

    step = tmk.GradStep(reads_the_device, torch.full((3,), 0.5,
                                                      device=cuda_device))
    with pytest.raises(RuntimeError):
        step()
    assert twf._SEGMENTED is None and step.graph is None
    with pytest.raises(RuntimeError):
        step()                         # no eager step in its place
    x.add_(1)
    good = tmk.GradStep(lambda p: (p * x).sum(),
                        torch.full((3,), 0.5, device=cuda_device))
    loss, grad = good()
    torch.cuda.synchronize()
    assert float(loss) == 3.0 and grad.tolist() == [2.0] * 3


@pytest.mark.cuda
def test_parameter_keeps_its_address_across_steps(cuda_device):
    loss_fn, true_bc = _problem(32, 16, 3, cuda_device)
    trained = ex.train(loss_fn, true_bc, steps=1, log=lambda *_: None)
    step = trained.step
    addresses = (step.param.data_ptr(), step.loss.data_ptr(),
                 step.grad.data_ptr())
    opt = torch.optim.Adam([step.param], lr=0.05)
    grads = []
    for _ in range(3):
        _, step.param.grad = step()
        grads.append(step.grad.clone())
        opt.step()
        with torch.no_grad():
            step.param.clamp_(0.0, 1.0)
    assert (step.param.data_ptr(), step.loss.data_ptr(),
            step.grad.data_ptr()) == addresses
    assert step.graph.launches == 4
    assert not torch.equal(grads[0], grads[-1])
